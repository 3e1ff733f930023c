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
// What bounds it on an H100: operations, not bytes. It needs 16 bytes of
// every ray (alive0 and t_exit read, t and hit written) and 28 more of a
// ray that starts alive (0.013-0.021 ms of memory time for a 1080p
// frame); the work
// is scalar fp32 arithmetic in a data-dependent march: per field
// evaluation that a ray needs, 30-46 flops for every prim whose support
// box holds the point, in K4 also 16 flops per center and pull-back
// iteration, in K2 23 per center in reach at every refresh. On a 1080p
// brain frame (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6) K4 runs
// at 0.44 of the fp32 bound for that work: its center loop takes about
// 12 instructions for 16 counted flops. K1 and K2 need 0.014 and 0.039 ms
// of arithmetic, a little more than their bytes, and both run at 0.02 of
// that bound: fixed costs hold them (the CTAs of empty tiles, the
// copy into shared memory, a march that is a serial chain of evals).
// What the kernel pays beyond the bound: prims of
// blocks that the warp's hull reaches and the lane's point does not, lanes
// of a warp that are done while others march, and the instruction
// slots of loads, branches and the march's own bookkeeping. Design:
//   * one ray a thread, one tile (a 16x16 pixel block at tile = 256) per
//     CTA; a warp takes an 8x4 pixel patch of it, so its rays end together
//     more often and its hull is tight;
//   * a tile with no live ray writes its misses and leaves before it
//     copies anything; the others copy prim rows, block boxes and, in K2
//     and K4, centers and weights into shared memory once, laid out for
//     wide loads (a prim row is six 16-byte loads, a center with its
//     weights one of 16 and one of 8): a scalar load costs an instruction
//     slot like a vector one. The center loop is paced by the bytes shared
//     memory hands to each lane, so a center takes its 24 bytes and no
//     padding (padded to 32 bytes the loop ran slower, and from
//     constant memory slower still);
//   * after that copy K1 and K4 have no CTA-wide barrier: a ray's result
//     does not depend on its neighbours, so every warp marches on its own
//     and leaves when its 32 rays are done. K2 keeps the tile-wide loop
//     test because its lanes refresh their rest-point model for as long
//     as the tile marches;
//   * the block cull is per warp and per eval: the hull of the points
//     whose value is needed (six warp reductions on integer keys), each
//     lane tests one block box against it, a ballot makes the list, and
//     the warp walks the set bits. The cull is exact (compact support: a
//     skipped block adds exactly 0), so the hull is taken over the needed
//     lanes alone and finished lanes do no work, in K4 no pull-back
//     either;
//   * K4 computes |x - c| directly, its square root as one
//     special-function instruction (sqrt.approx): the TPU kernel's
//     recentred quadratic expansion exists for its matrix unit and buys
//     nothing here.
// A counting build of each mode (the `counts` argument) adds up the needed
// lane-evals and 32 for every warp-eval that ran, whose ratio is the share
// of busy lanes; the shipped path does not count.
#include <cuda_runtime.h>

#include <cstddef>

#include "prim_field.cuh"

namespace {

using fb::Hull;
using fb::hull_meets;
using fb::kPrimRow;
using fb::prim_field;
using fb::support_radius_bound;
using fb::warp_hull;

constexpr int kPrimBlock = 8;
constexpr int kMaxThreads = 256;
// Three CTAs of 256 threads an SM: 80 registers a thread. The few spilled
// bytes that costs K2 and K3 are cheaper than running two CTAs an SM.
constexpr int kMinCtas = 3;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kRest = 0, kWendland = 1, kBiharmonic = 2 };

struct Args {
  const float* rays;       // [9, n] ro xyz, rd xyz, t_enter, t_exit, alive0
  const int* live;         // [tiles, n_blocks] blocks a tile may evaluate
  const float* boxes;      // [n_blocks, 6] block support boxes lo|hi
  const float* tile_rows;  // [tiles, 4] inv_stretch, shrink, slack, L
  const float* prims;      // [n_prims, kPrimRow]
  float* t_out;            // [n]
  float* hit_out;          // [n]
  unsigned long long* counts;  // counting build: needed lane-evals, lanes run
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

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout in 4-byte words, shared by host and device; every
// table starts on a 16-byte boundary. Boxes are stored as lo xyz _ | hi
// xyz _; a center with its weights takes 24 bytes, c xyz w_x in `centers`
// and w_y w_z in `weights`.
struct Layout {
  int prims, boxes, live, centers, weights, waff, cboxes, clive;
  int total;
};

__host__ __device__ inline Layout make_layout(const Args& a, int mode) {
  Layout L{};
  int o = 0;
  L.prims = o;  o += a.n_prims * kPrimRow;
  L.boxes = o;  o += a.n_blocks * 8;
  L.live = o;   o += round4(a.n_blocks);
  if (mode != kRest) {
    L.centers = o;  o += a.n_centers * 4;
    L.weights = o;  o += round4(a.n_centers * 2);
    L.waff = o;     o += 12;
  }
  if (mode == kWendland) {
    L.cboxes = o;   o += a.n_cb * 8;
    L.clive = o;    o += round4(a.n_cb);
  }
  L.total = o;
  return L;
}

struct Shared {
  const float* prims;
  const float4* boxes;
  const int* live;
  const float4* centers;  // c xyz, w_x
  const float2* weights;  // w_y, w_z
  const float* waff;
  const float4* cboxes;
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

// Copy n boxes [n, 6] into the padded lo xyz _ | hi xyz _ layout.
__device__ void fill_boxes(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n * 8; i += blockDim.x) {
    const int b = i >> 3, k = i & 7;
    dst[i] = (k & 3) == 3 ? 0.0f : src[6 * b + (k >> 2) * 3 + (k & 3)];
  }
}

// Which of the boxes flagged in `flags` the warp's hull meets, 32 boxes at
// a time from `base`: a ballot over one box per lane.
__device__ __forceinline__ unsigned live_mask(const int* flags,
                                              const float4* boxes, int n,
                                              int base, bool cull,
                                              const Hull& h) {
  const int b = base + (threadIdx.x & 31);
  bool ok = b < n && flags[b] != 0;
  if (ok && cull) ok = hull_meets(h, boxes[2 * b], boxes[2 * b + 1]);
  return __ballot_sync(kFull, ok);
}

// Rest field minus iso at a point, for the lanes with `need` set (the
// others get no value). Blocks are culled against the hull of the needed
// lanes' points. Every lane of the warp must call it.
__device__ float field_rest(const Args& a, const Shared& s, float x, float y,
                            float z, bool need) {
  if (!__any_sync(kFull, need)) return 0.0f;
  Hull h{};
  if (a.dyn_cull) h = warp_hull(need, x, y, z);
  float f = 0.0f;
  for (int base = 0; base < a.n_blocks; base += 32) {
    unsigned mask = live_mask(s.live, s.boxes, a.n_blocks, base,
                              a.dyn_cull != 0, h);
    if (!need) continue;
    while (mask) {
      const int b = base + __ffs(mask) - 1;
      mask &= mask - 1;
      const float* pb = s.prims + b * kPrimBlock * kPrimRow;
      float bs = 0.0f;
#pragma unroll 2
      for (int j = 0; j < kPrimBlock; ++j) {
        bs += prim_field(pb + j * kPrimRow, x, y, z);
      }
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
// are culled against the hull of the pmask lanes' estimates; only pmask
// lanes use the result. Every lane of the warp must call it.
__device__ void pull_one(const Args& a, const Shared& s, float xx, float yy,
                         float zz, float px, float py, float pz, bool pmask,
                         float& ox, float& oy, float& oz) {
  const Hull h = warp_hull(pmask, xx, yy, zz);
  float ux, uy, uz;
  affine_tail(s.waff, xx, yy, zz, ux, uy, uz);
  for (int base = 0; base < a.n_cb; base += 32) {
    unsigned mask = live_mask(s.clive, s.cboxes, a.n_cb, base, true, h);
    if (!pmask) continue;
    while (mask) {
      const int b = base + __ffs(mask) - 1;
      mask &= mask - 1;
      const float4* c4 = s.centers + b * a.cen_block;
      const float2* w2 = s.weights + b * a.cen_block;
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      for (int j = 0; j < a.cen_block; ++j) {
        const float4 c = c4[j];
        const float2 w = w2[j];
        const float dx = xx - c.x, dy = yy - c.y, dz = zz - c.z;
        const float d = sqrtf(dx * dx + dy * dy + dz * dz);
        const float tt = fminf(d * a.inv_sigma, 1.0f);
        const float omt = 1.0f - tt;
        const float o2 = omt * omt;
        const float ph = o2 * o2 * (4.0f * tt + 1.0f);  // Wendland C2
        sx += c.w * ph;
        sy += w.x * ph;
        sz += w.y * ph;
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
                               bool need) {
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
                    c.zr + a2 * c.vz, need);
}

// One special-function instruction; 0 at 0, so |x - c| needs no floor (the
// plain version's 1e-24 floor on d2 moves d by at most 1e-12).
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Biharmonic-deformed field minus iso at ray parameter t: fp_iters
// fixed-point iterations from the deformed point over every center, then
// the rest field at the pulled-back point. Only lanes that need the value
// pull back. The center loop is the kernel's whole cost on a frame whose
// rays march mostly through empty space, and it is paced by the bytes that
// shared memory hands to every lane: 24 per center.
__device__ float eval_biharmonic(const Args& a, const Shared& s,
                                 const Ray& r, float t, bool need) {
  const float px = r.ox + t * r.dx, py = r.oy + t * r.dy, pz = r.oz + t * r.dz;
  float xx = px, yy = py, zz = pz;
  if (need) {
    for (int it = 0; it < a.fp_iters; ++it) {
      float ux, uy, uz;
      affine_tail(s.waff, xx, yy, zz, ux, uy, uz);
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll 8
      for (int j = 0; j < a.n_centers; ++j) {
        const float4 c = s.centers[j];
        const float2 w = s.weights[j];
        const float dx = xx - c.x, dy = yy - c.y, dz = zz - c.z;
        const float d = sqrt_approx(dx * dx + dy * dy + dz * dz);
        sx += c.w * d;
        sy += w.x * d;
        sz += w.y * d;
      }
      xx = px - (ux + sx);
      yy = py - (uy + sy);
      zz = pz - (uz + sz);
    }
  }
  return field_rest(a, s, xx, yy, zz, need);
}

// Field minus iso at ray parameter t for the lanes with `need` set. Every
// lane of the warp must call it.
template <int kMode, bool kCount>
__device__ __forceinline__ float eval_at(const Args& a, const Shared& s,
                                         const Ray& r, float t, Carry& c,
                                         bool refresh, bool pmask, bool need) {
  if (kCount) {
    const unsigned m = __ballot_sync(kFull, need);
    if (m != 0 && (threadIdx.x & 31) == 0) {
      atomicAdd(a.counts, static_cast<unsigned long long>(__popc(m)));
      atomicAdd(a.counts + 1, 32ull);
    }
  }
  if (kMode == kWendland) {
    return eval_wendland(a, s, r, t, c, refresh, pmask, need);
  }
  if (kMode == kBiharmonic) return eval_biharmonic(a, s, r, t, need);
  return field_rest(a, s, r.ox + t * r.dx, r.oy + t * r.dy, r.oz + t * r.dz,
                    need);
}

// Whether the march goes on: while any ray of the tile is alive in K2,
// while any ray of the warp is in K1 and K4.
template <int kMode>
__device__ __forceinline__ bool any_alive(bool alive) {
  if (kMode == kWendland) return __syncthreads_or(alive) != 0;
  return __any_sync(kFull, alive) != 0;
}

template <int kMode, bool kCount>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
    trace_additive_kernel(Args a) {
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

  const Layout L = make_layout(a, kMode);
  {
    const float4* src = reinterpret_cast<const float4*>(a.prims);
    for (int i = tid; i < a.n_prims * (kPrimRow / 4); i += T) smem4[i] = src[i];
  }
  fill_boxes(smem + L.boxes, a.boxes, a.n_blocks);
  int* live = reinterpret_cast<int*>(smem + L.live);
  for (int i = tid; i < a.n_blocks; i += T) live[i] = a.live[tile * a.n_blocks + i];
  Shared s{smem + L.prims, reinterpret_cast<const float4*>(smem + L.boxes),
           live, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (kMode != kRest) {
    for (int i = tid; i < a.n_centers * 6; i += T) {
      const int j = i / 6, k = i - 6 * j;
      const float v = k < 3 ? a.centers[3 * j + k] : a.weights[3 * j + k - 3];
      smem[k < 4 ? L.centers + 4 * j + k : L.weights + 2 * j + k - 4] = v;
    }
    for (int i = tid; i < 12; i += T) smem[L.waff + i] = a.waff[i];
    s.centers = reinterpret_cast<const float4*>(smem + L.centers);
    s.weights = reinterpret_cast<const float2*>(smem + L.weights);
    s.waff = smem + L.waff;
  }
  if (kMode == kWendland) {
    fill_boxes(smem + L.cboxes, a.cboxes, a.n_cb);
    int* clive = reinterpret_cast<int*>(smem + L.clive);
    for (int i = tid; i < a.n_cb; i += T) clive[i] = a.clive[tile * a.n_cb + i];
    s.cboxes = reinterpret_cast<const float4*>(smem + L.cboxes);
    s.clive = clive;
  }
  __syncthreads();

  const Ray r{a.rays[g], a.rays[n + g], a.rays[2 * n + g],
              a.rays[3 * n + g], a.rays[4 * n + g], a.rays[5 * n + g]};
  const float t_enter = a.rays[6 * n + g];
  const float inv_stretch = a.tile_rows[4 * tile];
  const float shrink = a.tile_rows[4 * tile + 1];
  const float slack = a.tile_rows[4 * tile + 2];
  const float ldrift = a.tile_rows[4 * tile + 3];

  Carry c{r.ox + t_enter * r.dx, r.oy + t_enter * r.dy, r.oz + t_enter * r.dz,
          r.dx, r.dy, r.dz, t_enter};
  const float f0 =
      eval_at<kMode, kCount>(a, s, r, t_enter, c, true, alive0, alive0);
  float t = t_enter, f = f0, t_prev = t_enter, f_prev = f0;
  bool found = alive0 && f0 >= 0.0f;
  bool alive = alive0 && f0 < 0.0f;

  // `it` counts sub-steps; the loop test runs once per iteration.
  const int n_sub = kMode == kWendland ? a.k_refresh : 2;
  int it = 0;
  while (it < a.max_steps && any_alive<kMode>(alive)) {
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
      const float f_new =
          eval_at<kMode, kCount>(a, s, r, t_new, c, k == 0, alive0, alive);
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
  // refreshes the pull-back of the found lanes.
  float ta = t_prev, tb = t, fa = f_prev, fb = f;
  for (int i = 0; i < a.bisect_steps; ++i) {
    const float m = 0.5f * (ta + tb);
    const float fm =
        eval_at<kMode, kCount>(a, s, r, m, c, i == 0, found, found);
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

template <int kMode, bool kCount>
int launch_one(const Args& a, int tile, void* stream) {
  const size_t bytes = sizeof(float) * make_layout(a, kMode).total;
  cudaError_t err = cudaFuncSetAttribute(
      trace_additive_kernel<kMode, kCount>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_additive_kernel<kMode, kCount>
      <<<a.n_rays / tile, tile, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch(const Args& a, int tile, void* stream) {
  if (a.n_rays == 0) return 0;
  if (a.counts != nullptr) return launch_one<kMode, true>(a, tile, stream);
  return launch_one<kMode, false>(a, tile, stream);
}

Args common_args(const float* rays, const int* live, const float* boxes,
                 const float* tile_rows, const float* prims, float* t_out,
                 float* hit_out, unsigned long long* counts, int n_rays,
                 int n_prims, int n_blocks, int dyn_cull, float iso,
                 float r_iso, float base_step, int max_steps,
                 int bisect_steps) {
  Args a{};
  a.rays = rays;
  a.live = live;
  a.boxes = boxes;
  a.tile_rows = tile_rows;
  a.prims = prims;
  a.t_out = t_out;
  a.hit_out = hit_out;
  a.counts = counts;
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

// Every entry point returns a cudaError_t code (0 on success). `counts`
// is null, or two zeroed 64-bit counters for the counting build: needed
// lane-evals, and 32 for every warp-eval that ran.

// K1: rest trace.
extern "C" int fb_trace_additive_rest(
    const float* rays, const int* live, const float* boxes,
    const float* tile_rows, const float* prims, float* t_out, float* hit_out,
    unsigned long long* counts, int n_rays, int tile, int n_prims,
    int n_blocks, int dyn_cull, float iso, float r_iso, float base_step,
    int max_steps, int bisect_steps, void* stream) {
  const Args a = common_args(rays, live, boxes, tile_rows, prims, t_out,
                             hit_out, counts, n_rays, n_prims, n_blocks,
                             dyn_cull, iso, r_iso, base_step, max_steps,
                             bisect_steps);
  return launch<kRest>(a, tile, stream);
}

// K2: Wendland-deformed trace.
extern "C" int fb_trace_additive_wendland(
    const float* rays, const int* live, const float* boxes,
    const float* tile_rows, const float* prims, float* t_out, float* hit_out,
    unsigned long long* counts, int n_rays, int tile, int n_prims,
    int n_blocks, int dyn_cull, float iso, float r_iso, float base_step,
    int max_steps, int bisect_steps, const float* centers,
    const float* weights, const float* waff, const float* cboxes,
    const int* clive, int n_cb, int cen_block, float inv_sigma, int k_refresh,
    void* stream) {
  Args a = common_args(rays, live, boxes, tile_rows, prims, t_out, hit_out,
                       counts, n_rays, n_prims, n_blocks, dyn_cull, iso,
                       r_iso, base_step, max_steps, bisect_steps);
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

// K4: biharmonic-deformed trace.
extern "C" int fb_trace_additive_biharmonic(
    const float* rays, const int* live, const float* boxes,
    const float* tile_rows, const float* prims, float* t_out, float* hit_out,
    unsigned long long* counts, int n_rays, int tile, int n_prims,
    int n_blocks, int dyn_cull, float iso, float r_iso, float base_step,
    int max_steps, int bisect_steps, const float* centers,
    const float* weights, const float* waff, int n_centers, int fp_iters,
    void* stream) {
  Args a = common_args(rays, live, boxes, tile_rows, prims, t_out, hit_out,
                       counts, n_rays, n_prims, n_blocks, dyn_cull, iso,
                       r_iso, base_step, max_steps, bisect_steps);
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
