// Wide-row BVH walk: closest hit and any hit, one thread per ray.
//
// Replaces the TPU kernel _make_persistent_kernel
// (gfxexp_tpu/accel/pallas_persistent.py:102, launched by _run_persistent
// :352). The walk itself (and what bounds it) is in widerow_walk.cuh, shared
// with the two-level walk in instanced_traverse.cu. The plain PyTorch version
// is walk_plain in gfxexp_torch/accel/persistent.py.
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
widerow_walk(const float* __restrict__ nodes, int n_rows, int max_leaf,
             int n, const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin_in,
             const float* __restrict__ tmax_in, float* __restrict__ out_t,
             float* __restrict__ out_u, float* __restrict__ out_v,
             int* __restrict__ out_tri, unsigned char* __restrict__ out_hit) {
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
