// Per-ray march bracket from the prims' support boxes for Hopper (sm_90a),
// CUDA C++.
//
// The card path of fembrain_tpu_torch/render/sphere_trace.py
// `prim_interval`; its plain version is `_prim_interval_plain`, which tests
// every ray against every prim as dense [rays, prims] tensors. Both compute,
// per ray: the slab interval of every margin-inflated prim box, the hull
// [t_enter, t_exit] of the valid ones (exit >= enter, exit > 0, enter
// clamped at 0) and whether any is valid, intersected with the scene slab;
// a dead ray gets [0, 0]. The field is exactly zero outside the union of
// the boxes, so the tracers march only inside the bracket. It replaces no
// TPU kernel (the JAX package brackets with dense XLA operations,
// fembrain_tpu/render/sphere_trace.py `prim_interval`): on the card the
// dense test moved about 96 GB of [rays, prims] temporaries a 1080p frame.
//
// Bit for bit the plain version: the inflated boxes come from the host side
// already rounded as the plain version rounds them, each slab bound is
// (box - o) * inv with inv = 1 / d (d pushed to +-1e-12 where |d| < 1e-12)
// in round-to-nearest intrinsics, so nothing is contracted into an FMA or
// approximated, and every other step is a min, a max or a compare, which
// are exact. Inputs are finite, so no NaN arises.
//
// What bounds it on an H100: operations, not bytes. It reads 24 bytes of a
// ray and writes 9; the work is about 28 scalar fp32 instructions for every
// ray and prim (2.1 M rays x 163 prims at 1080p: 0.29 ms at one a lane a
// cycle; it takes 0.486 ms on an H100 80GB HBM3 at 700 W, PERF.md
// section 6). Design: one ray a thread, the inflated boxes staged in
// shared memory a chunk at a time as two float4 a prim (every lane reads
// the same prim at once, so the loads broadcast), the hull and the
// any-flag in registers; nothing of size [rays, prims] is ever written.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// Prims staged in shared memory at a time (8 KB).
constexpr int kChunk = 256;

struct Args {
  const float* ro;     // [n_rays, 3]
  const float* rd;     // [n_rays, 3]
  const float* boxes;  // [n_prims + 1, 6]: lo xyz, hi xyz; the slab last
  float* t_enter;      // [n_rays]
  float* t_exit;       // [n_rays]
  unsigned char* alive;  // [n_rays], 0 or 1
  int n_rays;
  int n_prims;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return __fdiv_rn(1.0f, s);
}

// The slab interval of box [lo, hi] along the ray: (enter, exit), enter
// not yet clamped at 0.
__device__ __forceinline__ void slab(const float (&o)[3], const float (&inv)[3],
                                     float lx, float ly, float lz, float hx,
                                     float hy, float hz, float& enter,
                                     float& exit_) {
  const float lo[3] = {lx, ly, lz};
  const float hi[3] = {hx, hy, hz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ta = __fmul_rn(__fsub_rn(lo[c], o[c]), inv[c]);
    const float tb = __fmul_rn(__fsub_rn(hi[c], o[c]), inv[c]);
    const float t_near = fminf(ta, tb);
    const float t_far = fmaxf(ta, tb);
    enter = c == 0 ? t_near : fmaxf(enter, t_near);
    exit_ = c == 0 ? t_far : fminf(exit_, t_far);
  }
}

__global__ void __launch_bounds__(kThreads)
    ray_bracket_kernel(const Args a) {
  __shared__ float4 s_lo[kChunk];
  __shared__ float4 s_hi[kChunk];
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const bool in = g < a.n_rays;
  float o[3] = {0.0f, 0.0f, 0.0f};
  float inv[3] = {1.0f, 1.0f, 1.0f};
  if (in) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = a.ro[3 * g + c];
      inv[c] = safe_inv(a.rd[3 * g + c]);
    }
  }
  float hull_enter = INFINITY;
  float hull_exit = -INFINITY;
  bool any = false;
  for (int base = 0; base < a.n_prims; base += kChunk) {
    const int n = min(kChunk, a.n_prims - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float* b = a.boxes + 6 * (base + k);
      s_lo[k] = make_float4(b[0], b[1], b[2], 0.0f);
      s_hi[k] = make_float4(b[3], b[4], b[5], 0.0f);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 lo = s_lo[k];
      const float4 hi = s_hi[k];
      float enter, exit_;
      slab(o, inv, lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, enter, exit_);
      enter = fmaxf(enter, 0.0f);
      const bool valid = exit_ >= enter && exit_ > 0.0f;
      hull_enter = valid ? fminf(hull_enter, enter) : hull_enter;
      hull_exit = valid ? fmaxf(hull_exit, exit_) : hull_exit;
      any = any || valid;
    }
  }
  if (!in) return;
  const float* s = a.boxes + 6 * a.n_prims;
  float s_enter, s_exit;
  slab(o, inv, s[0], s[1], s[2], s[3], s[4], s[5], s_enter, s_exit);
  s_enter = fmaxf(s_enter, 0.0f);
  const float t_enter = fmaxf(hull_enter, s_enter);
  const float t_exit = fminf(hull_exit, s_exit);
  const bool alive = any && s_exit > s_enter && t_exit >= t_enter;
  a.t_enter[g] = alive ? t_enter : 0.0f;
  a.t_exit[g] = alive ? t_exit : 0.0f;
  a.alive[g] = alive ? 1 : 0;
}

}  // namespace

// The bracket of `n_rays` rays against `n_prims` inflated prim boxes and the
// inflated scene slab (`boxes`, see Args). Returns a cudaError_t code (0 on
// success).
extern "C" int fb_ray_bracket(const float* ro, const float* rd,
                              const float* boxes, float* t_enter,
                              float* t_exit, unsigned char* alive, int n_rays,
                              int n_prims, void* stream) {
  if (n_rays == 0) return 0;
  const Args a{ro, rd, boxes, t_enter, t_exit, alive, n_rays, n_prims};
  const int grid = (n_rays + kThreads - 1) / kThreads;
  ray_bracket_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
