// Additive-scene tile sphere tracer for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel fembrain_tpu/render/pallas_trace.py
// `_trace_kernel_additive` (with `_march_tile`, `_pull_back_rows` and the
// in-kernel prim evaluator fembrain_tpu/ops/field.py `rows_prim_fields`)
// in its three modes, one template:
//   K1  kRest       : rest trace of the sum of Wyvill prim fields;
//   K2  kWendland   : trace of the Wendland-RBF-deformed field, every eval
//       pulling the march point back to rest space through a linear
//       rest-point model refreshed every k_refresh evals;
//   K4  kBiharmonic : trace of the biharmonic-RBF-deformed field, every
//       eval pulling back from scratch with fp_iters fixed-point iterations
//       x <- y - (sum_j w_j |x - c_j| + a + B x) over all M centers.
// The plain PyTorch version of all three is fembrain_tpu_torch/render/
// tile_trace.py `_march_plain`; the host-side layout is `prepare_tiles`.
//
// What bounds it on an H100: per ray it reads 36 bytes and writes 8, so
// device memory is idle; the work is scalar fp32 arithmetic in a
// data-dependent loop, about 30 flops per live prim (8 per block), in K2
// about 20 per live Wendland center (32 per block) at every refresh, and in
// K4 about 12 per center and iteration at every eval (brain: M = 112, two
// iterations, so the pull-back costs as much as the field). The limits are
// FP32 issue rate and the lanes a tile keeps busy after they finish: a
// tile marches until its last ray is done. Design:
//   * one ray per thread, one tile (a 16x16 pixel block at tile = 256)
//     per CTA, so neighbouring rays share a loop and a cull decision;
//   * prim rows, block boxes and, in K2 and K4, centers, weights (and K2's
//     center boxes) live in shared memory for the whole march (brain:
//     16 KB + 7 KB in K2, + 2.7 KB in K4);
//   * the hull of the live lanes' points is reduced per eval with warp
//     shuffles and a shared-memory pass, so every block cull is a branch
//     that is uniform across the CTA; the cull is exact (compact support);
//   * K4 computes |x - c| directly: the TPU kernel's recentred quadratic
//     expansion exists for its matrix unit and buys nothing here;
//   * lanes whose value is discarded skip the prim and center loops;
//   * the loop test is a CTA-wide `__syncthreads_or`, once per iteration of
//     two sub-steps (K1, K4) or one refresh plus k_refresh - 1 model evals
//     (K2).
#include <cuda_runtime.h>

#include <cstddef>

#include "prim_field.cuh"

namespace {

using fb::kPrimRow;
using fb::prim_field;
using fb::support_radius_bound;

constexpr int kPrimBlock = 8;
constexpr float kHullEps = 1e-4f;  // slack of the hull/box overlap test

enum Mode { kRest = 0, kWendland = 1, kBiharmonic = 2 };

struct Args {
  const float* rays;       // [9, n] ro xyz, rd xyz, t_enter, t_exit, alive0
  const int* live;         // [tiles, n_blocks] blocks a tile may evaluate
  const float* boxes;      // [n_blocks, 6] block support boxes lo|hi
  const float* tile_rows;  // [tiles, 4] inv_stretch, shrink, slack, L
  const float* prims;      // [n_prims, kPrimRow]
  float* t_out;            // [n]
  float* hit_out;          // [n]
  int n_rays, n_prims, n_blocks, dyn_cull;
  float iso, r_iso, base_step;
  int max_steps, bisect_steps;
  // Deformed modes: centers and kernel weights ([n_centers, 3] each), the
  // affine tail [3, 4] (column 0 constant, 1:4 linear).
  const float* centers;
  const float* weights;
  const float* waff;
  int n_centers;
  // Wendland mode only.
  const float* cboxes;     // [n_cb, 6]
  const int* clive;        // [tiles, n_cb]
  int n_cb, cen_block, k_refresh;
  float inv_sigma;
  // Biharmonic mode only.
  int fp_iters;
};

// Shared-memory layout in 4-byte words, shared by host and device.
struct Layout {
  int prims, boxes, red, hull, live, centers, weights, cboxes, waff, clive;
  int total;
};

__host__ __device__ inline Layout make_layout(const Args& a, int mode) {
  Layout L{};
  int o = 0;
  L.prims = o;  o += a.n_prims * kPrimRow;
  L.boxes = o;  o += a.n_blocks * 6;
  L.red = o;    o += 32 * 6;
  L.hull = o;   o += 8;
  L.live = o;   o += a.n_blocks;
  if (mode != kRest) {
    L.centers = o;  o += a.n_centers * 3;
    L.weights = o;  o += a.n_centers * 3;
    L.waff = o;     o += 12;
  }
  if (mode == kWendland) {
    L.cboxes = o;   o += a.n_cb * 6;
    L.clive = o;    o += a.n_cb;
  }
  L.total = o;
  return L;
}

struct Shared {
  const float* prims;
  const float* boxes;
  float* red;
  float* hull;
  const int* live;
  const float* centers;
  const float* weights;
  const float* cboxes;
  const float* waff;
  const int* clive;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Linear rest-point model of one lane: rest point (xr, yr, zr) at the last
// refresh tr and slope v; between refreshes x(t) = x_r + (t - t_r) v.
struct Carry {
  float xr, yr, zr, vx, vy, vz, tr;
};

// CTA-wide bounding box of (x, y, z) over the lanes with m set, written to
// hull[0..5] = lo xyz, hi xyz (1e30 / -1e30 when no lane is set). Every
// thread of the CTA must call it.
__device__ void cta_hull(bool m, float x, float y, float z, float* red,
                         float* hull) {
  float v[6] = {m ? x : 1e30f,  m ? y : 1e30f,  m ? z : 1e30f,
                m ? x : -1e30f, m ? y : -1e30f, m ? z : -1e30f};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
      v[k + 3] = fmaxf(v[k + 3], __shfl_xor_sync(0xffffffffu, v[k + 3], off));
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) red[warp * 6 + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = lane < n_warps ? red[lane * 6 + k] : 1e30f;
      v[k + 3] = lane < n_warps ? red[lane * 6 + k + 3] : -1e30f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
        v[k + 3] = fmaxf(v[k + 3], __shfl_xor_sync(0xffffffffu, v[k + 3], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) hull[k] = v[k];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool hull_meets(const float* h, const float* box) {
  return h[0] <= box[3] + kHullEps && h[3] >= box[0] - kHullEps &&
         h[1] <= box[4] + kHullEps && h[4] >= box[1] - kHullEps &&
         h[2] <= box[5] + kHullEps && h[5] >= box[2] - kHullEps;
}

// Rest field minus iso at a point. The block cull tests the hull of the
// alive0 lanes' points; `need` lanes evaluate the live blocks' prims.
__device__ float field_rest(const Args& a, const Shared& s, float x, float y,
                            float z, bool hull_lane, bool need) {
  if (a.dyn_cull) cta_hull(hull_lane, x, y, z, s.red, s.hull);
  float f = 0.0f;
  for (int b = 0; b < a.n_blocks; ++b) {
    if (!s.live[b]) continue;
    if (a.dyn_cull && !hull_meets(s.hull, s.boxes + 6 * b)) continue;
    if (need) {
      const float* pb = s.prims + b * kPrimBlock * kPrimRow;
      float bs = 0.0f;
#pragma unroll
      for (int j = 0; j < kPrimBlock; ++j) bs += prim_field(pb + j * kPrimRow, x, y, z);
      f += bs;
    }
  }
  return f - a.iso;
}

// The affine tail a + B x of the displacement.
__device__ __forceinline__ void affine_tail(const float* wa, float xx,
                                            float yy, float zz, float& ux,
                                            float& uy, float& uz) {
  ux = wa[0] + wa[1] * xx + wa[2] * yy + wa[3] * zz;
  uy = wa[4] + wa[5] * xx + wa[6] * yy + wa[7] * zz;
  uz = wa[8] + wa[9] * xx + wa[10] * yy + wa[11] * zz;
}

// One Wendland fixed-point pull-back iteration x <- y - u(x) at the
// estimate (xx, yy, zz) for the deformed point (px, py, pz). Center blocks
// are culled against the hull of the pmask lanes; only pmask lanes use the
// result.
__device__ void pull_one(const Args& a, const Shared& s, float xx, float yy,
                         float zz, float px, float py, float pz, bool pmask,
                         float& ox, float& oy, float& oz) {
  cta_hull(pmask, xx, yy, zz, s.red, s.hull);
  float ux, uy, uz;
  affine_tail(s.waff, xx, yy, zz, ux, uy, uz);
  for (int b = 0; b < a.n_cb; ++b) {
    if (!s.clive[b] || !hull_meets(s.hull, s.cboxes + 6 * b)) continue;
    if (pmask) {
      const float* c = s.centers + 3 * b * a.cen_block;
      const float* w = s.weights + 3 * b * a.cen_block;
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      for (int j = 0; j < a.cen_block; ++j) {
        const float dx = xx - c[3 * j], dy = yy - c[3 * j + 1],
                    dz = zz - c[3 * j + 2];
        const float d = sqrtf(dx * dx + dy * dy + dz * dz);
        const float tt = fminf(d * a.inv_sigma, 1.0f);
        const float omt = 1.0f - tt;
        const float o2 = omt * omt;
        const float ph = o2 * o2 * (4.0f * tt + 1.0f);  // Wendland C2
        sx += w[3 * j] * ph;
        sy += w[3 * j + 1] * ph;
        sz += w[3 * j + 2] * ph;
      }
      ux += sx;
      uy += sy;
      uz += sz;
    }
  }
  ox = px - ux;
  oy = py - uy;
  oz = pz - uz;
}

// Deformed field minus iso at ray parameter t: on a refresh, pull the
// model's estimate back once and refit the slope from the refresh-to-
// refresh secant; then evaluate the rest field at the model's point.
__device__ float eval_wendland(const Args& a, const Shared& s, const Ray& r,
                               float t, Carry& c, bool refresh, bool pmask,
                               bool hull_lane, bool need) {
  if (refresh) {
    const float adv = t - c.tr;
    float x2, y2, z2;
    pull_one(a, s, c.xr + adv * c.vx, c.yr + adv * c.vy, c.zr + adv * c.vz,
             r.ox + t * r.dx, r.oy + t * r.dy, r.oz + t * r.dz, pmask,
             x2, y2, z2);
    if (pmask) {
      if (adv > 1e-5f) {
        const float inv = 1.0f / adv;
        c.vx = (x2 - c.xr) * inv;
        c.vy = (y2 - c.yr) * inv;
        c.vz = (z2 - c.zr) * inv;
      }
      c.xr = x2;
      c.yr = y2;
      c.zr = z2;
      c.tr = t;
    }
  }
  const float a2 = t - c.tr;
  return field_rest(a, s, c.xr + a2 * c.vx, c.yr + a2 * c.vy,
                    c.zr + a2 * c.vz, hull_lane, need);
}

// Biharmonic-deformed field minus iso at ray parameter t: fp_iters
// fixed-point iterations from the deformed point over every center, then
// the rest field at the pulled-back point (its hull cull sees rest points).
// Lanes whose point neither enters the hull nor is used skip the pull-back.
__device__ float eval_biharmonic(const Args& a, const Shared& s,
                                 const Ray& r, float t, bool hull_lane,
                                 bool need) {
  const float px = r.ox + t * r.dx, py = r.oy + t * r.dy, pz = r.oz + t * r.dz;
  float xx = px, yy = py, zz = pz;
  if (need || (a.dyn_cull && hull_lane)) {
    for (int it = 0; it < a.fp_iters; ++it) {
      float ux, uy, uz;
      affine_tail(s.waff, xx, yy, zz, ux, uy, uz);
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      for (int j = 0; j < a.n_centers; ++j) {
        const float dx = xx - s.centers[3 * j], dy = yy - s.centers[3 * j + 1],
                    dz = zz - s.centers[3 * j + 2];
        const float d = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-24f));
        sx += s.weights[3 * j] * d;
        sy += s.weights[3 * j + 1] * d;
        sz += s.weights[3 * j + 2] * d;
      }
      xx = px - (ux + sx);
      yy = py - (uy + sy);
      zz = pz - (uz + sz);
    }
  }
  return field_rest(a, s, xx, yy, zz, hull_lane, need);
}

template <int kMode>
__device__ __forceinline__ float eval_at(const Args& a, const Shared& s,
                                         const Ray& r, float t, Carry& c,
                                         bool refresh, bool pmask,
                                         bool hull_lane, bool need) {
  if (kMode == kWendland) {
    return eval_wendland(a, s, r, t, c, refresh, pmask, hull_lane, need);
  }
  if (kMode == kBiharmonic) {
    return eval_biharmonic(a, s, r, t, hull_lane, need);
  }
  return field_rest(a, s, r.ox + t * r.dx, r.oy + t * r.dy, r.oz + t * r.dz,
                    hull_lane, need);
}

template <int kMode>
__global__ void trace_additive_kernel(Args a) {
  extern __shared__ float smem[];
  const Layout L = make_layout(a, kMode);
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  for (int i = tid; i < a.n_prims * kPrimRow; i += T) smem[L.prims + i] = a.prims[i];
  for (int i = tid; i < a.n_blocks * 6; i += T) smem[L.boxes + i] = a.boxes[i];
  int* live = reinterpret_cast<int*>(smem + L.live);
  for (int i = tid; i < a.n_blocks; i += T) live[i] = a.live[tile * a.n_blocks + i];
  Shared s{smem + L.prims, smem + L.boxes, smem + L.red, smem + L.hull, live,
           nullptr, nullptr, nullptr, nullptr, nullptr};
  if (kMode != kRest) {
    const int m3 = a.n_centers * 3;
    for (int i = tid; i < m3; i += T) {
      smem[L.centers + i] = a.centers[i];
      smem[L.weights + i] = a.weights[i];
    }
    for (int i = tid; i < 12; i += T) smem[L.waff + i] = a.waff[i];
    s.centers = smem + L.centers;
    s.weights = smem + L.weights;
    s.waff = smem + L.waff;
  }
  if (kMode == kWendland) {
    for (int i = tid; i < a.n_cb * 6; i += T) smem[L.cboxes + i] = a.cboxes[i];
    int* clive = reinterpret_cast<int*>(smem + L.clive);
    for (int i = tid; i < a.n_cb; i += T) clive[i] = a.clive[tile * a.n_cb + i];
    s.cboxes = smem + L.cboxes;
    s.clive = clive;
  }
  __syncthreads();

  const int n = a.n_rays;
  const int g = tile * T + tid;
  const Ray r{a.rays[g], a.rays[n + g], a.rays[2 * n + g],
              a.rays[3 * n + g], a.rays[4 * n + g], a.rays[5 * n + g]};
  const float t_enter = a.rays[6 * n + g];
  const float t_exit = a.rays[7 * n + g];
  const bool alive0 = a.rays[8 * n + g] > 0.0f;
  const float inv_stretch = a.tile_rows[4 * tile];
  const float shrink = a.tile_rows[4 * tile + 1];
  const float slack = a.tile_rows[4 * tile + 2];
  const float ldrift = a.tile_rows[4 * tile + 3];

  // A tile with no live ray skips the march: every lane misses.
  if (!__syncthreads_or(alive0)) {
    a.t_out[g] = t_exit;
    a.hit_out[g] = 0.0f;
    return;
  }

  Carry c{r.ox + t_enter * r.dx, r.oy + t_enter * r.dy, r.oz + t_enter * r.dz,
          r.dx, r.dy, r.dz, t_enter};
  const float f0 = eval_at<kMode>(a, s, r, t_enter, c, true, alive0,
                                  alive0, alive0);
  float t = t_enter, f = f0, t_prev = t_enter, f_prev = f0;
  bool found = alive0 && f0 >= 0.0f;
  bool alive = alive0 && f0 < 0.0f;

  // `it` counts sub-steps; the loop test runs once per iteration.
  const int n_sub = kMode == kWendland ? a.k_refresh : 2;
  int it = 0;
  while (it < a.max_steps && __syncthreads_or(alive)) {
    for (int k = 0; k < n_sub; ++k) {
      const float rr = support_radius_bound(f + a.iso);
      float d = (rr - a.r_iso) * inv_stretch;
      if (kMode == kWendland) {
        // The model's staleness 2 L |t - t_r| comes off d before both
        // deformed-space bounds.
        const float de = d - 2.0f * ldrift * fabsf(t - c.tr);
        d = fmaxf(shrink * de, de - slack);
      } else {
        d = fmaxf(shrink * d, d - slack);
      }
      const float dt = fmaxf(a.base_step, 0.95f * d);
      const float t_new = fminf(t + dt, t_exit);
      const float f_new = eval_at<kMode>(a, s, r, t_new, c, k == 0, alive0,
                                         alive0, alive);
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

  // Bisection on [t_prev, t], then a secant. In K2 the first halving
  // refreshes the pull-back with the hull narrowed to the found lanes.
  float ta = t_prev, tb = t, fa = f_prev, fb = f;
  for (int i = 0; i < a.bisect_steps; ++i) {
    const float m = 0.5f * (ta + tb);
    const float fm = eval_at<kMode>(a, s, r, m, c, i == 0, found, alive0,
                                    found);
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

template <int kMode>
int launch(const Args& a, int tile, void* stream) {
  if (a.n_rays == 0) return 0;
  const size_t bytes = sizeof(float) * make_layout(a, kMode).total;
  cudaError_t err = cudaFuncSetAttribute(
      trace_additive_kernel<kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_additive_kernel<kMode>
      <<<a.n_rays / tile, tile, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args common_args(const float* rays, const int* live, const float* boxes,
                 const float* tile_rows, const float* prims, float* t_out,
                 float* hit_out, int n_rays, int n_prims, int n_blocks,
                 int dyn_cull, float iso, float r_iso, float base_step,
                 int max_steps, int bisect_steps) {
  Args a{};
  a.rays = rays;
  a.live = live;
  a.boxes = boxes;
  a.tile_rows = tile_rows;
  a.prims = prims;
  a.t_out = t_out;
  a.hit_out = hit_out;
  a.n_rays = n_rays;
  a.n_prims = n_prims;
  a.n_blocks = n_blocks;
  a.dyn_cull = dyn_cull;
  a.iso = iso;
  a.r_iso = r_iso;
  a.base_step = base_step;
  a.max_steps = max_steps;
  a.bisect_steps = bisect_steps;
  return a;
}

}  // namespace

// K1: rest trace. Returns a cudaError_t code (0 on success).
extern "C" int fb_trace_additive_rest(
    const float* rays, const int* live, const float* boxes,
    const float* tile_rows, const float* prims, float* t_out, float* hit_out,
    int n_rays, int tile, int n_prims, int n_blocks, int dyn_cull, float iso,
    float r_iso, float base_step, int max_steps, int bisect_steps,
    void* stream) {
  const Args a = common_args(rays, live, boxes, tile_rows, prims, t_out,
                             hit_out, n_rays, n_prims, n_blocks, dyn_cull, iso,
                             r_iso, base_step, max_steps, bisect_steps);
  return launch<kRest>(a, tile, stream);
}

// K2: Wendland-deformed trace. Returns a cudaError_t code (0 on success).
extern "C" int fb_trace_additive_wendland(
    const float* rays, const int* live, const float* boxes,
    const float* tile_rows, const float* prims, float* t_out, float* hit_out,
    int n_rays, int tile, int n_prims, int n_blocks, int dyn_cull, float iso,
    float r_iso, float base_step, int max_steps, int bisect_steps,
    const float* centers, const float* weights, const float* waff,
    const float* cboxes, const int* clive, int n_cb, int cen_block,
    float inv_sigma, int k_refresh, void* stream) {
  Args a = common_args(rays, live, boxes, tile_rows, prims, t_out, hit_out,
                       n_rays, n_prims, n_blocks, dyn_cull, iso, r_iso,
                       base_step, max_steps, bisect_steps);
  a.centers = centers;
  a.weights = weights;
  a.waff = waff;
  a.n_centers = n_cb * cen_block;
  a.cboxes = cboxes;
  a.clive = clive;
  a.n_cb = n_cb;
  a.cen_block = cen_block;
  a.inv_sigma = inv_sigma;
  a.k_refresh = k_refresh;
  return launch<kWendland>(a, tile, stream);
}

// K4: biharmonic-deformed trace. Returns a cudaError_t code (0 on success).
extern "C" int fb_trace_additive_biharmonic(
    const float* rays, const int* live, const float* boxes,
    const float* tile_rows, const float* prims, float* t_out, float* hit_out,
    int n_rays, int tile, int n_prims, int n_blocks, int dyn_cull, float iso,
    float r_iso, float base_step, int max_steps, int bisect_steps,
    const float* centers, const float* weights, const float* waff,
    int n_centers, int fp_iters, void* stream) {
  Args a = common_args(rays, live, boxes, tile_rows, prims, t_out, hit_out,
                       n_rays, n_prims, n_blocks, dyn_cull, iso, r_iso,
                       base_step, max_steps, bisect_steps);
  a.centers = centers;
  a.weights = weights;
  a.waff = waff;
  a.n_centers = n_centers;
  a.fp_iters = fp_iters;
  return launch<kBiharmonic>(a, tile, stream);
}

extern "C" const char* fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
