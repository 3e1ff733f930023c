// General BlobTree tile sphere tracer for Hopper (sm_90a), CUDA C++ (K3).
//
// Replaces the Pallas TPU kernel fembrain_tpu/render/pallas_trace.py
// `_trace_kernel` (with `_march_tile`) and its in-kernel field evaluator
// fembrain_tpu/ops/field.py `field_rows` with the warp math of
// fembrain_tpu/ops/warp.py `warp_components`. Every scene the additive
// kernel does not take goes here: differences, intersections, unions,
// Ricci blends, warps. Per eval and ray: each warp group's chain warps the
// point root-first, each prim's Wyvill field is taken at its group's point
// (prim_field.cuh), and the op fold runs along the schedule with op values
// in a small per-thread register file (the scene's fold plan); range ops
// fold their prims on the fly. The march steps by the Wyvill support bound
// where the field is monotone, by the fixed base step elsewhere.
// The plain PyTorch version is fembrain_tpu_torch/render/tile_trace.py
// `trace_tiles_general_plain`; the host-side layout is `prepare_general`.
//
// What bounds it on an H100: per ray it reads 36 bytes and writes 8; the
// work is scalar fp32 arithmetic, about 30 flops per prim and eval with no
// cull (the general fold admits none), times the evals of a fixed-step
// march on non-monotone scenes. The limits are FP32 issue rate and the
// lanes a tile keeps busy after they finish. Design:
//   * one ray per thread, one tile (a 16x16 pixel block at tile = 256)
//     per CTA, two masked sub-steps per `__syncthreads_or` loop test;
//   * prim rows, the op steps and the warp chains live in shared memory
//     for the whole march (brain resection: 16 KB);
//   * a lane evaluates the field only where its value is used;
//   * the warped point of the last group seen is cached, so scenes whose
//     groups are contiguous warp once per group and eval.
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

#include "prim_field.cuh"

namespace {

using fb::kPrimRow;
using fb::prim_field;
using fb::support_radius_bound;

constexpr int kStepRow = 6;   // otype, dst, l_kind, l_idx, r_kind, r_idx
constexpr int kWarpRow = 8;   // wtype, axis_a, axis_b, pad, params[4]
constexpr int kMaxRegs = 32;  // tile_trace.MAX_REGS

enum Src { kSrcReg = 0, kSrcPrim = 1, kSrcRange = 2, kSrcZero = 3 };
enum OpType {
  kUnion = 0, kIntersect = 1, kDif = 2, kSmoothDif = 3, kBlend = 4,
  kRicci = 5, kGradientBlend = 6, kFastQuadric = 7, kCache = 8,
  kTwist = 9, kTaper = 10, kBend = 11, kShear = 12,
};

struct Args {
  const float* rays;         // [9, n] ro xyz, rd xyz, t_enter, t_exit, alive0
  const float* prims;        // [n_prims, kPrimRow], aux = warp group
  const int* steps;          // [n_steps, kStepRow] fold in schedule order
  const float* step_params;  // [n_steps, 2] op params 0:2
  const float* warps;        // [n_groups * chain_len, kWarpRow]
  float* t_out;              // [n]
  float* hit_out;            // [n]
  int n_rays, n_prims, n_real, n_steps, n_groups, chain_len;
  int root_is_op, root_reg, adaptive;
  float iso, r_iso, base_step, inv_stretch;
  int max_steps, bisect_steps;
};

struct Layout {
  int prims, steps, params, warps, total;
};

__host__ __device__ inline Layout make_layout(const Args& a) {
  Layout L{};
  int o = 0;
  L.prims = o;   o += a.n_prims * kPrimRow;
  L.steps = o;   o += a.n_steps * kStepRow;
  L.params = o;  o += a.n_steps * 2;
  L.warps = o;   o += a.n_groups * a.chain_len * kWarpRow;
  L.total = o;
  return L;
}

struct Shared {
  const float* prims;
  const int* steps;
  const float* params;
  const float* warps;
};

// The inverse deformation of one warp op applied to a point (ops/warp.py
// warp_components): twist about axis_a, taper of axis_b along axis_a,
// bend in the xy plane, shear of axis_b along axis_a.
__device__ void apply_warp(const float* w, float& x, float& y, float& z) {
  const int wtype = static_cast<int>(w[0]);
  const int aa = static_cast<int>(w[1]);
  const int ab = static_cast<int>(w[2]);
  const float* p = w + 4;
  float c[3] = {x, y, z};
  switch (wtype) {
    case kTwist: {
      const int ia = (aa + 1) % 3, ib = (aa + 2) % 3;
      const float ang = -p[0] * c[aa];
      const float cs = cosf(ang), sn = sinf(ang);
      const float va = c[ia], vb = c[ib];
      c[ia] = cs * va - sn * vb;
      c[ib] = sn * va + cs * vb;
      break;
    }
    case kTaper: {
      const float s = 1.0f + p[0] * c[aa];
      float safe = s;
      if (fabsf(s) < 1e-6f) {
        const float sign = s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f);
        safe = sign * 1e-6f + (s == 0.0f ? 1e-6f : 0.0f);
      }
      c[ab] = c[ab] / safe;
      break;
    }
    case kBend: {
      const float k = p[0], center = p[1], lbound = p[2], rbound = p[3];
      if (!(fabsf(k) < 1e-8f)) {
        const float cy = 1.0f / k;
        const float xc = fminf(fmaxf(c[0], lbound), rbound);
        const float theta = -k * (xc - center);
        const float cs = cosf(theta), sn = sinf(theta);
        const float xr = cs * (c[0] - center) - sn * (c[1] - cy);
        const float yr = sn * (c[0] - center) + cs * (c[1] - cy);
        c[0] = xr + center;
        c[1] = yr + cy;
      }
      break;
    }
    case kShear:
      c[ab] = c[ab] - p[0] * c[aa];
      break;
    default:
      break;
  }
  x = c[0];
  y = c[1];
  z = c[2];
}

// Prim fields at one world point, each at its warp group's point; the
// last group's warped point is cached.
struct PrimEval {
  const Args& a;
  const Shared& s;
  float x, y, z;
  int group = -1;
  float wx = 0.0f, wy = 0.0f, wz = 0.0f;

  __device__ float operator()(int i) {
    const float* p = s.prims + i * kPrimRow;
    const int g = static_cast<int>(p[23]);
    if (g != group) {
      wx = x;
      wy = y;
      wz = z;
      const float* chain = s.warps + g * a.chain_len * kWarpRow;
      for (int j = 0; j < a.chain_len; ++j) {
        if (chain[j * kWarpRow] < 0.0f) break;
        apply_warp(chain + j * kWarpRow, wx, wy, wz);
      }
      group = g;
    }
    return prim_field(p, wx, wy, wz);
  }
};

__device__ __forceinline__ float binary_op(int otype, float lf, float rf,
                                           float p0, float p1) {
  switch (otype) {
    case kUnion: return fmaxf(lf, rf);
    case kIntersect: return fminf(lf, rf);
    case kRicci: return powf(powf(lf, p0) + powf(rf, p0), p1);
    case kDif: return fminf(lf, 1.0f - rf);
    case kSmoothDif: return lf * (1.0f - rf);
    case kBlend:
    case kGradientBlend:
    case kFastQuadric: return lf + rf;
    default: return lf;  // warps and CACHE pass through the fold
  }
}

// Range op over prims lo..hi: max (UNION), masked min (INTERSECT), Ricci
// power sum, sum otherwise.
__device__ float range_op(PrimEval& pe, int otype, int lo, int hi, float p0,
                          float p1) {
  float v;
  switch (otype) {
    case kUnion:
      v = -INFINITY;
      for (int i = lo; i <= hi; ++i) v = fmaxf(v, pe(i));
      return v;
    case kIntersect:
      v = INFINITY;
      for (int i = lo; i <= hi; ++i) v = fminf(v, pe(i));
      return v;
    case kRicci:
      v = 0.0f;
      for (int i = lo; i <= hi; ++i) v += powf(pe(i), p0);
      return powf(v, p1);
    default:
      v = 0.0f;
      for (int i = lo; i <= hi; ++i) v += pe(i);
      return v;
  }
}

// BlobTree field minus iso at a point.
__device__ float general_field(const Args& a, const Shared& s, float x,
                               float y, float z) {
  PrimEval pe{a, s, x, y, z};
  if (!a.root_is_op) {
    float f = 0.0f;
    for (int i = 0; i < a.n_real; ++i) f += pe(i);
    return f - a.iso;
  }
  float regs[kMaxRegs];
  for (int k = 0; k < a.n_steps; ++k) {
    const int* st = s.steps + k * kStepRow;
    const int otype = st[0], dst = st[1], lk = st[2], li = st[3], rk = st[4],
              ri = st[5];
    const float p0 = s.params[2 * k], p1 = s.params[2 * k + 1];
    float v;
    if (lk == kSrcRange) {
      v = range_op(pe, otype, li, ri, p0, p1);
    } else {
      const float lf = lk == kSrcReg ? regs[li] : pe(li);
      const float rf =
          rk == kSrcZero ? 0.0f : (rk == kSrcReg ? regs[ri] : pe(ri));
      v = binary_op(otype, lf, rf, p0, p1);
    }
    regs[dst] = v;
  }
  return regs[a.root_reg] - a.iso;
}

__global__ void trace_general_kernel(Args a) {
  extern __shared__ float smem[];
  const Layout L = make_layout(a);
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  for (int i = tid; i < a.n_prims * kPrimRow; i += T) smem[L.prims + i] = a.prims[i];
  int* steps = reinterpret_cast<int*>(smem + L.steps);
  for (int i = tid; i < a.n_steps * kStepRow; i += T) steps[i] = a.steps[i];
  for (int i = tid; i < a.n_steps * 2; i += T) smem[L.params + i] = a.step_params[i];
  const int nw = a.n_groups * a.chain_len * kWarpRow;
  for (int i = tid; i < nw; i += T) smem[L.warps + i] = a.warps[i];
  const Shared s{smem + L.prims, steps, smem + L.params, smem + L.warps};
  __syncthreads();

  const int n = a.n_rays;
  const int g = tile * T + tid;
  const float ox = a.rays[g], oy = a.rays[n + g], oz = a.rays[2 * n + g];
  const float dx = a.rays[3 * n + g], dy = a.rays[4 * n + g],
              dz = a.rays[5 * n + g];
  const float t_enter = a.rays[6 * n + g];
  const float t_exit = a.rays[7 * n + g];
  const bool alive0 = a.rays[8 * n + g] > 0.0f;

  // A tile with no live ray skips the march: every lane misses.
  if (!__syncthreads_or(alive0)) {
    a.t_out[g] = t_exit;
    a.hit_out[g] = 0.0f;
    return;
  }

  auto eval = [&](float t, bool need) {
    return need ? general_field(a, s, ox + t * dx, oy + t * dy, oz + t * dz)
                : 0.0f;
  };
  const float f0 = eval(t_enter, alive0);
  float t = t_enter, f = f0, t_prev = t_enter, f_prev = f0;
  bool found = alive0 && f0 >= 0.0f;
  bool alive = alive0 && f0 < 0.0f;

  // Two masked sub-steps per loop test; `it` counts sub-steps.
  int it = 0;
  while (it < a.max_steps && __syncthreads_or(alive)) {
    for (int k = 0; k < 2; ++k) {
      float dt = a.base_step;
      if (a.adaptive) {
        const float d = (support_radius_bound(f + a.iso) - a.r_iso) *
                        a.inv_stretch;
        dt = fmaxf(a.base_step, 0.95f * d);
      }
      const float t_new = fminf(t + dt, t_exit);
      const float f_new = eval(t_new, alive);
      if (alive) {
        const bool crossed = f_new >= 0.0f;
        const bool done = t_new >= t_exit && f_new < 0.0f;
        t_prev = t;
        f_prev = f;
        t = t_new;
        f = f_new;
        found = found || crossed;
        alive = !crossed && !done;
      }
      ++it;
    }
  }

  // Bisection on [t_prev, t], then a secant.
  float ta = t_prev, tb = t, fa = f_prev, fb = f;
  for (int i = 0; i < a.bisect_steps; ++i) {
    const float m = 0.5f * (ta + tb);
    const float fm = eval(m, found);
    if (fm < 0.0f) {
      ta = m;
      fa = fm;
    } else {
      tb = m;
      fb = fm;
    }
  }
  const float denom = fb - fa;
  const float t_sec =
      ta - fa * (tb - ta) / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
  const float t_root = fabsf(denom) < 1e-9f ? 0.5f * (ta + tb) : t_sec;
  a.t_out[g] = found ? t_root : t_exit;
  a.hit_out[g] = found ? 1.0f : 0.0f;
}

}  // namespace

// K3: general trace. Returns a cudaError_t code (0 on success).
extern "C" int fb_trace_general(
    const float* rays, const float* prims, const int* steps,
    const float* step_params, const float* warps, float* t_out,
    float* hit_out, int n_rays, int tile, int n_prims, int n_real,
    int n_steps, int n_groups, int chain_len, int root_is_op, int root_reg,
    int adaptive, float iso, float r_iso, float base_step, float inv_stretch,
    int max_steps, int bisect_steps, void* stream) {
  Args a{};
  a.rays = rays;
  a.prims = prims;
  a.steps = steps;
  a.step_params = step_params;
  a.warps = warps;
  a.t_out = t_out;
  a.hit_out = hit_out;
  a.n_rays = n_rays;
  a.n_prims = n_prims;
  a.n_real = n_real;
  a.n_steps = n_steps;
  a.n_groups = n_groups;
  a.chain_len = chain_len;
  a.root_is_op = root_is_op;
  a.root_reg = root_reg;
  a.adaptive = adaptive;
  a.iso = iso;
  a.r_iso = r_iso;
  a.base_step = base_step;
  a.inv_stretch = inv_stretch;
  a.max_steps = max_steps;
  a.bisect_steps = bisect_steps;
  if (n_rays == 0) return 0;
  const size_t bytes = sizeof(float) * make_layout(a).total;
  cudaError_t err = cudaFuncSetAttribute(
      trace_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_general_kernel<<<n_rays / tile, tile, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
