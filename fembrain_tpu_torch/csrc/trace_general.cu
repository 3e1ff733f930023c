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
// What bounds it on an H100: operations, not bytes. It needs 16 bytes of
// every ray and 28 more of a ray that starts alive (0.015 ms of memory
// time); the work is scalar fp32 arithmetic, 30-46 flops for
// every prim whose support box holds the evaluation point, times the
// evals of a fixed-step march on non-monotone scenes. With the culls
// below that is under 0.04 ms of arithmetic on the 1080p brain resection
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), where the kernel
// runs at 0.035 of its bound: fixed costs hold it (the CTAs of empty
// tiles, the copy into shared memory, a march that is a serial chain of
// evals). What the kernel pays beyond the bound: prims that the warp's
// hull reaches and the lane's point does not, lanes of a warp that are
// done while others march, the fold's table reads and its op registers
// in local memory. Design:
//   * one ray a thread, one tile (a 16x16 pixel block at tile = 256) per
//     CTA, a warp on an 8x4 pixel patch of it; a tile with no live ray
//     leaves before it copies anything; after the copy there is no CTA-wide
//     barrier: a ray's result does not depend on its neighbours, so every
//     warp marches on its own, two masked sub-steps per loop test;
//   * a prim's field is exactly 0 outside its support box whatever op
//     consumes it, so prims under no warp are culled: per tile by static
//     flags from the host (the tile's ray hull against the prim boxes),
//     and per warp and eval against the hull of the points whose value is
//     needed (six warp reductions, one box test per lane, a ballot per 32
//     prims kept as a bit mask in shared memory). A culled prim
//     contributes the 0.0 it would have computed, so results do not
//     change by a bit; sums walk the mask's set bits. Prims under a warp
//     chain are always evaluated;
//   * prim rows, the op steps (two 16-byte loads each) and the warp chains
//     live in shared memory for the whole march;
//   * the warped point of the last group seen is cached, so scenes whose
//     groups are contiguous warp once per group and eval.
// A counting build (the `counts` argument) adds up the needed lane-evals,
// 32 for every warp-eval that ran and 32 for every prim a warp's mask let
// run; the shipped path does not count.
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

#include "prim_field.cuh"

namespace {

using fb::Hull;
using fb::hull_meets;
using fb::kPrimRow;
using fb::prim_field;
using fb::support_radius_bound;
using fb::warp_hull;

constexpr int kStepRow = 6;   // otype, dst, l_kind, l_idx, r_kind, r_idx
constexpr int kStepWords = 8;  // in shared memory: the row, then p0, p1
constexpr int kWarpRow = 8;   // wtype, axis_a, axis_b, pad, params[4]
constexpr int kMaxRegs = 32;  // tile_trace.MAX_REGS
constexpr int kMaxThreads = 256;
// Three CTAs of 256 threads an SM: 80 registers a thread. The few spilled
// bytes that costs K2 and K3 are cheaper than running two CTAs an SM.
constexpr int kMinCtas = 3;
constexpr unsigned kFull = 0xffffffffu;

enum Src { kSrcReg = 0, kSrcPrim = 1, kSrcRange = 2, kSrcZero = 3 };
enum OpType {
  kUnion = 0, kIntersect = 1, kDif = 2, kSmoothDif = 3, kBlend = 4,
  kRicci = 5, kGradientBlend = 6, kFastQuadric = 7, kCache = 8,
  kTwist = 9, kTaper = 10, kBend = 11, kShear = 12,
};
enum Live { kDead = 0, kBoxed = 1, kAlways = 2 };

struct Args {
  const float* rays;         // [9, n] ro xyz, rd xyz, t_enter, t_exit, alive0
  const float* prims;        // [n_prims, kPrimRow], aux = warp group
  const int* steps;          // [n_steps, kStepRow] fold in schedule order
  const float* step_params;  // [n_steps, 2] op params 0:2
  const float* warps;        // [n_groups * chain_len, kWarpRow]
  const int* live;           // [tiles, n_prims] kDead, kBoxed or kAlways
  const float* boxes;        // [n_prims, 6] prim support boxes lo|hi
  float* t_out;              // [n]
  float* hit_out;            // [n]
  unsigned long long* counts;  // counting build: needed lane-evals, lanes
                               // run, lane-prims run
  int n_rays, n_prims, n_real, n_steps, n_groups, chain_len;
  int root_is_op, root_reg, adaptive;
  float iso, r_iso, base_step, inv_stretch;
  int max_steps, bisect_steps;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int mask_words(const Args& a) {
  return (a.n_prims + 31) >> 5;
}

// Shared-memory layout in 4-byte words; every table starts on a 16-byte
// boundary. Boxes are stored as lo xyz _ | hi xyz _.
struct Layout {
  int prims, boxes, steps, warps, live, wmask, total;
};

__host__ __device__ inline Layout make_layout(const Args& a, int n_warps) {
  Layout L{};
  int o = 0;
  L.prims = o;  o += a.n_prims * kPrimRow;
  L.boxes = o;  o += a.n_prims * 8;
  L.steps = o;  o += a.n_steps * kStepWords;
  L.warps = o;  o += a.n_groups * a.chain_len * kWarpRow;
  L.live = o;   o += round4(a.n_prims);
  L.wmask = o;  o += round4(n_warps * mask_words(a));
  L.total = o;
  return L;
}

struct Shared {
  const float* prims;
  const float4* boxes;
  const int4* steps;
  const float* warps;
  const int* live;
  unsigned* wmask;  // this warp's live-prim bits
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
// last group's warped point is cached. A prim whose bit is clear in the
// warp's mask is outside its support box: its field is the 0.0 it would
// have computed.
struct PrimEval {
  const Args& a;
  const Shared& s;
  float x, y, z;
  int group = -1;
  float wx = 0.0f, wy = 0.0f, wz = 0.0f;

  __device__ bool live(int i) const {
    return (s.wmask[i >> 5] >> (i & 31)) & 1u;
  }

  // The field of a prim whose bit is set.
  __device__ float field(int i) {
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

  __device__ float operator()(int i) { return live(i) ? field(i) : 0.0f; }

  // Sum over prims lo..hi in index order; culled prims add exactly 0, so
  // only the set bits are walked.
  __device__ float sum(int lo, int hi) {
    float v = 0.0f;
    for (int c = lo >> 5; c <= hi >> 5; ++c) {
      unsigned m = s.wmask[c];
      if (c == lo >> 5) m &= kFull << (lo & 31);
      if (c == hi >> 5) m &= kFull >> (31 - (hi & 31));
      while (m) {
        v += field(32 * c + __ffs(m) - 1);
        m &= m - 1;
      }
    }
    return v;
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
      return pe.sum(lo, hi);
  }
}

// The op fold at one point.
__device__ float fold(const Args& a, const Shared& s, float x, float y,
                      float z) {
  PrimEval pe{a, s, x, y, z};
  if (!a.root_is_op) return pe.sum(0, a.n_real - 1) - a.iso;
  float regs[kMaxRegs];
  for (int k = 0; k < a.n_steps; ++k) {
    const int4 s0 = s.steps[2 * k], s1 = s.steps[2 * k + 1];
    const int otype = s0.x, dst = s0.y, lk = s0.z, li = s0.w, rk = s1.x,
              ri = s1.y;
    const float p0 = __int_as_float(s1.z), p1 = __int_as_float(s1.w);
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

// BlobTree field minus iso at a point, for the lanes with `need` set (the
// others get no value). Every lane of the warp must call it.
template <bool kCount>
__device__ float general_field(const Args& a, const Shared& s, float x,
                               float y, float z, bool need) {
  const unsigned needed = __ballot_sync(kFull, need);
  if (needed == 0) return 0.0f;
  const int lane = threadIdx.x & 31;
  if (kCount && lane == 0) {
    atomicAdd(a.counts, static_cast<unsigned long long>(__popc(needed)));
    atomicAdd(a.counts + 1, 32ull);
  }
  // This eval's live prims: always-live ones, and boxed ones whose box
  // meets the hull of the needed lanes' points.
  const Hull h = warp_hull(need, x, y, z);
  for (int c = 0; c < mask_words(a); ++c) {
    const int i = 32 * c + lane;
    const int flag = i < a.n_prims ? s.live[i] : kDead;
    const bool ok =
        flag == kAlways ||
        (flag == kBoxed && hull_meets(h, s.boxes[2 * i], s.boxes[2 * i + 1]));
    const unsigned m = __ballot_sync(kFull, ok);
    if (lane == 0) s.wmask[c] = m;
    if (kCount && lane == 0) atomicAdd(a.counts + 2, 32ull * __popc(m));
  }
  __syncwarp();
  const float f = need ? fold(a, s, x, y, z) : 0.0f;
  __syncwarp();  // the next eval rewrites the mask
  return f;
}

template <bool kCount>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
    trace_general_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  // A tile of 256 rays is a 16x16 pixel block in row-major order: warp w
  // takes the 8x4 patch at column 8 (w & 1), row 4 (w >> 1).
  int slot = tid;
  if (T == 256) {
    const int w = tid >> 5, l = tid & 31;
    slot = ((w >> 1) * 4 + (l >> 3)) * 16 + (w & 1) * 8 + (l & 7);
  }
  const int n = a.n_rays;
  const int g = tile * T + slot;
  const float t_exit = a.rays[7 * n + g];
  const bool alive0 = a.rays[8 * n + g] > 0.0f;

  // A tile with no live ray skips the copy and the march: every lane
  // misses.
  if (!__syncthreads_or(alive0)) {
    a.t_out[g] = t_exit;
    a.hit_out[g] = 0.0f;
    return;
  }

  const Layout L = make_layout(a, T >> 5);
  {
    const float4* src = reinterpret_cast<const float4*>(a.prims);
    for (int i = tid; i < a.n_prims * (kPrimRow / 4); i += T) smem4[i] = src[i];
  }
  for (int i = tid; i < a.n_prims * 8; i += T) {
    const int b = i >> 3, k = i & 7;
    smem[L.boxes + i] =
        (k & 3) == 3 ? 0.0f : a.boxes[6 * b + (k >> 2) * 3 + (k & 3)];
  }
  int* steps = reinterpret_cast<int*>(smem + L.steps);
  for (int i = tid; i < a.n_steps * kStepWords; i += T) {
    const int k = i >> 3, j = i & 7;
    steps[i] = j < kStepRow
                   ? a.steps[k * kStepRow + j]
                   : __float_as_int(a.step_params[2 * k + j - kStepRow]);
  }
  const int nw = a.n_groups * a.chain_len * kWarpRow;
  for (int i = tid; i < nw; i += T) smem[L.warps + i] = a.warps[i];
  int* live = reinterpret_cast<int*>(smem + L.live);
  for (int i = tid; i < a.n_prims; i += T) live[i] = a.live[tile * a.n_prims + i];
  const Shared s{smem + L.prims,
                 reinterpret_cast<const float4*>(smem + L.boxes),
                 reinterpret_cast<const int4*>(steps), smem + L.warps, live,
                 reinterpret_cast<unsigned*>(smem + L.wmask) +
                     (tid >> 5) * mask_words(a)};
  __syncthreads();

  const float ox = a.rays[g], oy = a.rays[n + g], oz = a.rays[2 * n + g];
  const float dx = a.rays[3 * n + g], dy = a.rays[4 * n + g],
              dz = a.rays[5 * n + g];
  const float t_enter = a.rays[6 * n + g];

  auto eval = [&](float t, bool need) {
    return general_field<kCount>(a, s, ox + t * dx, oy + t * dy, oz + t * dz,
                                 need);
  };
  const float f0 = eval(t_enter, alive0);
  float t = t_enter, f = f0, t_prev = t_enter, f_prev = f0;
  bool found = alive0 && f0 >= 0.0f;
  bool alive = alive0 && f0 < 0.0f;

  // Two masked sub-steps per loop test; `it` counts sub-steps. The test is
  // the warp's own.
  int it = 0;
  while (it < a.max_steps && __any_sync(kFull, alive)) {
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

template <bool kCount>
int launch(const Args& a, int tile, void* stream) {
  const size_t bytes = sizeof(float) * make_layout(a, tile >> 5).total;
  cudaError_t err = cudaFuncSetAttribute(
      trace_general_kernel<kCount>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_general_kernel<kCount>
      <<<a.n_rays / tile, tile, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: general trace. Returns a cudaError_t code (0 on success). `counts`
// is null, or zeroed 64-bit counters for the counting build, of which it
// adds to the first three: needed lane-evals, 32 for every warp-eval that
// ran, 32 for every prim a warp's mask let run.
extern "C" int fb_trace_general(
    const float* rays, const float* prims, const int* steps,
    const float* step_params, const float* warps, const int* live,
    const float* boxes, float* t_out, float* hit_out,
    unsigned long long* counts, int n_rays, int tile, int n_prims, int n_real,
    int n_steps, int n_groups, int chain_len, int root_is_op, int root_reg,
    int adaptive, float iso, float r_iso, float base_step, float inv_stretch,
    int max_steps, int bisect_steps, void* stream) {
  Args a{};
  a.rays = rays;
  a.prims = prims;
  a.steps = steps;
  a.step_params = step_params;
  a.warps = warps;
  a.live = live;
  a.boxes = boxes;
  a.t_out = t_out;
  a.hit_out = hit_out;
  a.counts = counts;
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
  if (counts != nullptr) return launch<true>(a, tile, stream);
  return launch<false>(a, tile, stream);
}
