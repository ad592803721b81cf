// ReSTIR DI's resampling, one thread a pixel with its reservoir in
// registers: the initial candidate stream over the presampled light pool,
// and one biased spatial reuse pass, each in one launch.
//
// Replaces no TPU kernel: the JAX technique
// (gfxexp_tpu/techniques/restir_di.py) is plain jnp, which XLA fuses on the
// TPU. In the port the two passes are Python loops over candidates and
// neighbours, each step a few dozen PyTorch launches over [N] and [N, 3]
// tensors: at 1080p ~2,100 launches for the initial stream and ~950 for a
// spatial pass, and the frame waited on the host that launched them. Their
// plain versions, restir_di.initial_ris_presampled and
// restir_di.spatial_reuse, run every route restir_di.restir_kernel_admits
// refuses and every call on the CPU.
//
// restir_initial_kernel (initial_ris_presampled): the 8x8 tile's pool subset
// from pcg3d(tile, frame, 77), reduced unsigned; per candidate the pool
// slot, the unshadowed contribution (bsdf_evaluate on the pixel's BSDF
// parameters), its target density and the streaming reservoir update, drawn
// from SampleStream(pixel, frame, 0x5152) in the plain version's order; then
// the RIS estimate (rec_pdf, and the bad lanes zeroed). With a shadow ray
// buffer it writes the winner's shadow ray (direction, and t_max -1 on the
// lanes that trace none) for the any-hit walk that follows.
//
// restir_spatial_kernel (a biased spatial_reuse pass with low-discrepancy
// neighbours): per neighbour the pixel offset (computed on the host as the
// plain version computes it), the neighbour test against the G-buffer, the
// neighbour's reservoir, its target and weight, and the update drawn from
// SampleStream(pixel, frame, 0x5a00 + pass); then the estimate with weight
// 1 / stream length. It reads one reservoir set and writes another.
//
// Rounding: as shading.cuh says. The target density, cont.mean(-1), is
// summed as PyTorch's CUDA reduction sums a row of three, (x + z) + y (two
// threads a row, the second's value added last), and scaled by the
// reduction's float factor, rows / elements, which the host computes.
//
// What bounds it: bytes. The initial kernel reads a pixel's context
// (position, v_out_local, the frame t, b, n, diffuse, f0, roughness and two
// flags: 90 B) and writes its reservoir (53 B) and shadow ray (16 B); the
// pool (41 B an entry, 5.4 MB at 128 x 1024) stays in L2. A spatial pass
// reads the context and the camera distance (94 B), the reservoirs (53 B a
// pixel) and the G-buffer's hit, position and normal (25 B), and writes a
// reservoir (53 B); the neighbours' gathers read those arrays again at one
// offset for the whole pass, mostly from L2. One thread a pixel with no
// shared memory: a warp's pixels lie on one row, so the [N, 3] arrays are
// read whole by a warp, and a neighbour's gathers land on one row too.
//
// Built by gfxexp_torch/csrc/build.py with nvcc into a shared library with a
// plain C interface (ctypes); it launches on the caller's stream, does not
// synchronise and allocates nothing.

#include "shading.cuh"

// the most neighbours a spatial pass takes (restir_di.py
// _MAX_KERNEL_NEIGHBORS)
constexpr int kMaxNeighbors = 32;

// The arguments, one struct a kernel (restir_di.py _InitialArgs and
// _SpatialArgs mirror them). The pixel context is PixelCtx's tensors; a
// reservoir is ReservoirSoA's eight.
struct InitialArgs {
  int n, w, frame, num_subsets, subset_size, n_cand;
  float mean_scale;  // the target density's factor: n / (3 n) in float
  // the pixel context
  const float* pos;    // [n, 3] offset surface position
  const float* v_out;  // [n, 3] v_out_local
  const float* t;      // [n, 3]
  const float* b;      // [n, 3]
  const float* nrm;    // [n, 3]
  const float* diffuse;  // [n, 3]
  const float* f0;       // [n, 3]
  const float* rough;    // [n]
  const unsigned char* lambert;  // [n]
  const unsigned char* valid;    // [n]
  // the pool, [P] and [P, 3]
  const float* pool_pos;
  const float* pool_nrm;
  const float* pool_emit;
  const unsigned char* pool_inf;
  const float* pool_rec;
  // out: the reservoir
  float* r_pos;
  float* r_nrm;
  float* r_emit;
  unsigned char* r_inf;
  float* r_sum_w;
  float* r_len;
  float* r_rec;
  float* r_target;
  // out (both or neither): the shadow ray of reuse_visibility
  float* shadow_d;  // [n, 3]
  float* shadow_tmax;
};

struct SpatialArgs {
  int n, w, h, frame, pass, n_nb;
  float mean_scale;
  float dx[kMaxNeighbors];  // the neighbours' offsets in pixels
  float dy[kMaxNeighbors];
  // the pixel context
  const float* pos;
  const float* v_out;
  const float* t;
  const float* b;
  const float* nrm;
  const float* diffuse;
  const float* f0;
  const float* rough;
  const unsigned char* lambert;
  const unsigned char* valid;
  const float* cam_dist;  // [n]
  const float* cam_pos;   // [3]
  // the G-buffer, flat
  const unsigned char* gb_hit;  // [n]
  const float* gb_pos;          // [n, 3]
  const float* gb_nrm;          // [n, 3]
  // the reservoirs read
  const float* in_pos;
  const float* in_nrm;
  const float* in_emit;
  const unsigned char* in_inf;
  const float* in_sum_w;
  const float* in_len;
  const float* in_rec;
  const float* in_target;
  // the reservoirs written
  float* r_pos;
  float* r_nrm;
  float* r_emit;
  unsigned char* r_inf;
  float* r_sum_w;
  float* r_len;
  float* r_rec;
  float* r_target;
};

namespace {

constexpr int kBlock = 128;

// restir_di.py PixelCtx, one pixel
struct Ctx {
  V3 pos, v_out, t, b, n;
  Params prm;
  bool valid;
};

template <typename A>
__device__ __forceinline__ Ctx load_ctx(const A& a, int i) {
  Ctx c;
  c.pos = load3(a.pos, i);
  c.v_out = load3(a.v_out, i);
  c.t = load3(a.t, i);
  c.b = load3(a.b, i);
  c.n = load3(a.nrm, i);
  c.prm.diffuse = load3(a.diffuse, i);
  c.prm.f0 = load3(a.f0, i);
  c.prm.rough = a.rough[i];
  c.prm.lambert = a.lambert[i] != 0;
  c.valid = a.valid[i] != 0;
  return c;
}

// core/rng.py pcg3d: its first output
__device__ __forceinline__ unsigned int pcg3d_x(unsigned int v0,
                                                unsigned int v1,
                                                unsigned int v2) {
  unsigned int x = v0 * 1664525u + 1013904223u;
  unsigned int y = v1 * 1664525u + 1013904223u;
  unsigned int z = v2 * 1664525u + 1013904223u;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  return x;
}

__device__ __forceinline__ Rng make_rng(int lane, int sample, int stream) {
  Rng rs;
  rs.lane = (unsigned int)lane;
  rs.sample = (unsigned int)sample;
  rs.stream = (unsigned int)stream;
  rs.dim = 0;
  rs.used = 4;
  return rs;
}

// _unshadowed_contribution: direct lighting of a light sample without
// visibility
__device__ __forceinline__ V3 unshadowed(const Ctx& c, V3 l_pos, V3 l_nrm,
                                         V3 l_emit, bool l_inf) {
  const V3 shadow_vec = l_inf ? l_pos : sub(l_pos, c.pos);
  const float dist2 = clamp_min(dot(shadow_vec, shadow_vec), 1e-12f);
  const float r = sqrtf(dist2);
  const V3 sdir = V3{shadow_vec.x / r, shadow_vec.y / r, shadow_vec.z / r};
  const V3 v_in_local = to_local(c.t, c.b, c.n, sdir);
  const float lp_cos = dot(neg(sdir), l_nrm);
  const float sp_cos = v_in_local.z;
  const V3 le = scale(l_emit, kInvPi);
  const V3 f = bsdf_evaluate(c.prm, c.v_out, v_in_local);
  const float g = l_inf ? fabsf(sp_cos) : lp_cos * fabsf(sp_cos) / dist2;
  const V3 cont = scale(mul(f, le), g);
  return (lp_cos > 0.0f && c.valid) ? cont : V3{0.0f, 0.0f, 0.0f};
}

// _target_density: cont.mean(-1) as PyTorch's CUDA reduction takes it
__device__ __forceinline__ float target_density(V3 c, float mean_scale) {
  return ((c.x + c.z) + c.y) * mean_scale;
}

// One reservoir in registers, and the target of its selected sample.
struct Reservoir {
  V3 pos, nrm, emit;
  bool inf;
  float sum_w, sel_target;
};

// _reservoir_update's stream step (the caller keeps the stream length)
__device__ __forceinline__ void update(Reservoir& r, V3 pos, V3 nrm, V3 emit,
                                       bool inf, float weight, float u,
                                       float target) {
  r.sum_w = r.sum_w + weight;
  const bool accept = (u * r.sum_w < weight) && (weight > 0.0f);
  if (accept) {
    r.pos = pos;
    r.nrm = nrm;
    r.emit = emit;
    r.inf = inf;
    r.sel_target = target;
  }
}

// The estimate, and the reservoir stored: rec_pdf = num / den, zeroed
// with the target where it is not finite or the target is not positive
// (_ris_estimate: num = sum_w, den = target * stream_len; _finish_reuse:
// num = weight * sum_w, den = target)
template <typename A>
__device__ __forceinline__ float store(const A& a, int i, const Reservoir& r,
                                       float len, float num, float den) {
  float rec = num / clamp_min(den, 1e-30f);
  float target = r.sel_target;
  if (!isfinite(rec) || target <= 0.0f) {
    rec = 0.0f;
    target = 0.0f;
  }
  store3(a.r_pos, i, r.pos);
  store3(a.r_nrm, i, r.nrm);
  store3(a.r_emit, i, r.emit);
  a.r_inf[i] = r.inf ? 1 : 0;
  a.r_sum_w[i] = r.sum_w;
  a.r_len[i] = len;
  a.r_rec[i] = rec;
  a.r_target[i] = target;
  return target;
}

__global__ void __launch_bounds__(kBlock)
restir_initial_kernel(const InitialArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ctx c = load_ctx(a, i);
  const int px = i % a.w;
  const int py = i / a.w;
  const int tile = (py / 8) * ((a.w + 7) / 8) + px / 8;
  const long long subset =
      pcg3d_x((unsigned int)tile, (unsigned int)a.frame, 77u) %
      (unsigned int)a.num_subsets;
  const long long size = a.subset_size;
  Rng rs = make_rng(i, a.frame, 0x5152);

  Reservoir r{V3{0.0f, 0.0f, 0.0f}, V3{0.0f, 0.0f, 0.0f},
              V3{0.0f, 0.0f, 0.0f}, false, 0.0f, 0.0f};
  float len = 0.0f;
  for (int k = 0; k < a.n_cand; ++k) {
    const float u = rs.next();
    const long long local = (long long)(u * (float)a.subset_size);
    const int slot = (int)(subset * size + (local < size - 1 ? local
                                                               : size - 1));
    const V3 p_pos = load3(a.pool_pos, slot);
    const V3 p_nrm = load3(a.pool_nrm, slot);
    const V3 p_emit = load3(a.pool_emit, slot);
    const bool p_inf = a.pool_inf[slot] != 0;
    const float target = target_density(
        unshadowed(c, p_pos, p_nrm, p_emit, p_inf), a.mean_scale);
    update(r, p_pos, p_nrm, p_emit, p_inf, target * a.pool_rec[slot],
           rs.next(), target);
    len = len + 1.0f;
  }
  const float target = store(a, i, r, len, r.sum_w, r.sel_target * len);

  if (a.shadow_d != nullptr) {
    // _visibility's ray: none where the pixel is invalid or the target 0
    const V3 vec = r.inf ? r.pos : sub(r.pos, c.pos);
    const float dist = length(vec);
    const float d = clamp_min(dist, 1e-12f);
    store3(a.shadow_d, i, V3{vec.x / d, vec.y / d, vec.z / d});
    const float tmax = r.inf ? 1e10f : dist * 0.9999f;
    a.shadow_tmax[i] = (c.valid && target > 0.0f) ? tmax : -1.0f;
  }
}

__global__ void __launch_bounds__(kBlock)
restir_spatial_kernel(const SpatialArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ctx c = load_ctx(a, i);
  const float cam_dist = a.cam_dist[i];
  const V3 cam = load3(a.cam_pos, 0);
  const int px = i % a.w;
  const int py = i / a.w;
  const float fx = (float)px + 0.5f;
  const float fy = (float)py + 0.5f;
  Rng rs = make_rng(i, a.frame, 0x5a00 + a.pass);

  // the pixel's own reservoir, its weight kept where its estimate is
  const bool keep_self = a.in_rec[i] > 0.0f;
  Reservoir r{load3(a.in_pos, i), load3(a.in_nrm, i), load3(a.in_emit, i),
              a.in_inf[i] != 0, keep_self ? a.in_sum_w[i] : 0.0f,
              keep_self ? a.in_target[i] : 0.0f};
  float len = a.in_len[i];
  for (int k = 0; k < a.n_nb; ++k) {
    const long long nbx = (long long)floorf(fx + a.dx[k]);
    const long long nby = (long long)floorf(fy + a.dy[k]);
    const bool in_bounds = nbx >= 0 && nbx < a.w && nby >= 0 && nby < a.h;
    const bool not_self = nbx != px || nby != py;
    const long long cx = nbx < 0 ? 0 : (nbx > a.w - 1 ? a.w - 1 : nbx);
    const long long cy = nby < 0 ? 0 : (nby > a.h - 1 ? a.h - 1 : nby);
    const int nb = (int)(cy * a.w + cx);
    // _neighbor_ok with the geometry test (biased)
    const float nb_dist = length(sub(cam, load3(a.gb_pos, nb)));
    const bool ok =
        in_bounds && not_self && a.gb_hit[nb] != 0 && c.valid &&
        fabsf(nb_dist - cam_dist) / clamp_min(cam_dist, 1e-6f) <= 0.1f &&
        dot(c.n, load3(a.gb_nrm, nb)) >= 0.9f;

    const float nb_len = a.in_len[nb];
    const V3 n_pos = load3(a.in_pos, nb);
    const V3 n_nrm = load3(a.in_nrm, nb);
    const V3 n_emit = load3(a.in_emit, nb);
    const bool n_inf = a.in_inf[nb] != 0;
    const float target = target_density(
        unshadowed(c, n_pos, n_nrm, n_emit, n_inf), a.mean_scale);
    const float weight = ok ? target * a.in_rec[nb] * nb_len : 0.0f;
    update(r, n_pos, n_nrm, n_emit, n_inf, weight, rs.next(), target);
    len = len + (ok ? nb_len : 0.0f);
  }
  // `1.0 / x` of a tensor x is reciprocal(x) * 1.0
  const float w = 1.0f / clamp_min(len, 1e-30f);
  store(a, i, r, len, w * r.sum_w, r.sel_target);
}

}  // namespace

extern "C" {

// sizeof each argument struct, so the caller can check its layout
int restir_initial_args_size() { return (int)sizeof(InitialArgs); }
int restir_spatial_args_size() { return (int)sizeof(SpatialArgs); }

// Each returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
int restir_initial_launch(const InitialArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const InitialArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.w <= 0 || a.num_subsets <= 0 || a.subset_size <= 0 || a.n_cand < 0 ||
      (a.shadow_d == nullptr) != (a.shadow_tmax == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  restir_initial_kernel<<<(a.n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

int restir_spatial_launch(const SpatialArgs* args, cudaStream_t stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const SpatialArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.w <= 0 || a.h <= 0 || (long long)a.w * a.h != a.n || a.n_nb < 0 ||
      a.n_nb > kMaxNeighbors) {
    return (int)cudaErrorInvalidValue;
  }
  restir_spatial_kernel<<<(a.n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
