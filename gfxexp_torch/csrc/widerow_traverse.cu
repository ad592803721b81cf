// Wide-row BVH walk: closest hit and any hit, one thread per ray.
//
// Replaces the TPU kernel _make_persistent_kernel
// (gfxexp_tpu/accel/pallas_persistent.py:102, launched by _run_persistent
// :352). Row format: gfxexp_torch/accel/widerow.py. The plain PyTorch
// version of this walk is walk_plain in gfxexp_torch/accel/persistent.py;
// both apply the same operations in the same order, so with --fmad=false
// their results are equal.
//
// What bounds it: each step is one dependent load of a 256-byte row (internal
// rows read 7*K floats, leaf rows 16 floats a triangle) followed by a few
// dozen FLOPs, so the walk is bound by the latency of those dependent loads,
// not by arithmetic. Every thread walks on its own (no packets), rows are read
// as float4 through the read-only path, and the bench scene's table (about
// 1 MB) stays resident in the 50 MB L2. The stack lives in local memory.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 64;       // floats per row
constexpr int kMaxStack = 128;   // compile-time stack bound (entries)
constexpr int kBlock = 128;

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

template <bool kAnyHit, int K>
__global__ void __launch_bounds__(kBlock)
widerow_walk(const float* __restrict__ nodes, int n_rows, int max_leaf,
             int n, const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin_in,
             const float* __restrict__ tmax_in, float* __restrict__ out_t,
             float* __restrict__ out_u, float* __restrict__ out_v,
             int* __restrict__ out_tri, unsigned char* __restrict__ out_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tmin = tmin_in[i];
  const float tmax = tmax_in[i];
  float best_t = tmax, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;

  if (tmax >= 0.0f) {
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    int stack[kMaxStack];
    int sp = 0;
    int cur = 0;
    while (cur >= 0) {
      cur = min(cur, n_rows - 1);
      const float4* row =
          reinterpret_cast<const float4*>(nodes + (size_t)cur * kWidth);
      const float4 tail = __ldg(row + 15);  // cols 60..63
      int nxt = -1;
      if (tail.w > 0.5f) {
        // leaf: Baldwin-Weber triangles inline, ids first | count << 24
        const int packed = __float_as_int(tail.x);
        const int fst = packed & 0xFFFFFF;
        const int cnt = packed >> 24;
        for (int j = 0; j < max_leaf && j < cnt; ++j) {
          const float4 pn = __ldg(row + 3 * j + 0);  // n.xyz d0
          const float4 pu = __ldg(row + 3 * j + 1);  // U.xyz Ud
          const float4 pv = __ldg(row + 3 * j + 2);  // V.xyz Vd
          const float den = pn.x * dx + pn.y * dy + pn.z * dz;
          const float num = pn.x * ox + pn.y * oy + pn.z * oz + pn.w;
          const bool den_ok = fabsf(den) > 1e-12f;
          const float t = -num / (den_ok ? den : 1.0f);
          const float px = ox + t * dx;
          const float py = oy + t * dy;
          const float pz = oz + t * dz;
          const float u = pu.x * px + pu.y * py + pu.z * pz + pu.w;
          const float v = pv.x * px + pv.y * py + pv.z * pz + pv.w;
          if (den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
              t > tmin && t < best_t) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_tri = fst + j;
            if (kAnyHit) goto done;
          }
        }
      } else {
        // internal: K children of 7 floats (lo.xyz hi.xyz child row)
        float r[7 * K];
#pragma unroll
        for (int q = 0; q < 7 * K / 4; ++q) {
          const float4 f = __ldg(row + q);
          r[4 * q + 0] = f.x;
          r[4 * q + 1] = f.y;
          r[4 * q + 2] = f.z;
          r[4 * q + 3] = f.w;
        }
        float nr[K];
        int mt[K];
        bool vd[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float* c = r + 7 * k;
          const float tx0 = (c[0] - ox) * ix;
          const float tx1 = (c[3] - ox) * ix;
          const float ty0 = (c[1] - oy) * iy;
          const float ty1 = (c[4] - oy) * iy;
          const float tz0 = (c[2] - oz) * iz;
          const float tz1 = (c[5] - oz) * iz;
          const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                   fmaxf(fminf(tz0, tz1), tmin));
          const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                  fminf(fmaxf(tz0, tz1), best_t));
          const int meta = __float_as_int(c[6]);
          const bool ok = near <= far && meta >= 0;
          nr[k] = ok ? near : CUDART_INF_F;
          mt[k] = meta;
          vd[k] = ok;
        }
        sort_children<K>(nr, mt, vd);
#pragma unroll
        for (int s = K - 1; s >= 1; --s) {
          if (vd[s]) {
            if (sp < kMaxStack) stack[sp] = mt[s];
            ++sp;
          }
        }
        nxt = vd[0] ? mt[0] : -1;
      }
      if (nxt < 0 && sp > 0) {
        --sp;
        nxt = sp < kMaxStack ? stack[sp] : -1;
      }
      cur = nxt;
    }
  }
done:
  out_t[i] = best_t;
  out_u[i] = best_u;
  out_v[i] = best_v;
  out_tri[i] = best_tri;
  out_hit[i] = best_tri >= 0 ? 1 : 0;
}

template <bool kAnyHit, int K>
cudaError_t launch(const float* nodes, int n_rows, int max_leaf, int n,
                   const float* o, const float* d, const float* tmin,
                   const float* tmax, float* t, float* u, float* v, int* tri,
                   unsigned char* hit, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  widerow_walk<kAnyHit, K><<<grid, kBlock, 0, stream>>>(
      nodes, n_rows, max_leaf, n, o, d, tmin, tmax, t, u, v, tri, hit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int widerow_max_stack() { return kMaxStack; }

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
// stack_depth is the table's bound, checked against kMaxStack.
int widerow_walk_launch(int any_hit, int arity, const float* nodes,
                        int n_rows, int max_leaf, int stack_depth, int n,
                        const float* o, const float* d, const float* tmin,
                        const float* tmax, float* t, float* u, float* v,
                        int* tri, unsigned char* hit, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || max_leaf < 0 || max_leaf > 5 ||
      stack_depth > kMaxStack) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (arity == 4) {
    err = any_hit ? launch<true, 4>(nodes, n_rows, max_leaf, n, o, d, tmin,
                                    tmax, t, u, v, tri, hit, stream)
                  : launch<false, 4>(nodes, n_rows, max_leaf, n, o, d, tmin,
                                     tmax, t, u, v, tri, hit, stream);
  } else if (arity == 8) {
    err = any_hit ? launch<true, 8>(nodes, n_rows, max_leaf, n, o, d, tmin,
                                    tmax, t, u, v, tri, hit, stream)
                  : launch<false, 8>(nodes, n_rows, max_leaf, n, o, d, tmin,
                                     tmax, t, u, v, tri, hit, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
