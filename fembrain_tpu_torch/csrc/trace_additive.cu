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
// tile_trace.py `_march_plain`; the host-side layout is `prepare_tiles`
// (with `pack_tables` and `live_patches`).
//
// What bounds it on an H100: operations, not bytes. It needs 16 bytes of
// every ray (alive0 and t_exit read, t and hit written) and 28 more of a
// ray that starts alive (0.013-0.021 ms of memory time for a 1080p
// frame); the work is scalar fp32 arithmetic in a data-dependent march:
// per field evaluation that a ray needs, 30-46 flops for every prim whose
// support box holds the point, in K4 also 16 flops per center and
// pull-back iteration, in K2 23 per center in reach at every refresh. On a
// 1080p brain frame (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6) K4
// runs at 0.44 of the fp32 bound for that work: its center loop takes
// about 12 instructions for 16 counted flops. K1 and K2 need 0.014 and
// 0.039 ms of arithmetic, a little more than their bytes, and were
// measured to pay for it in instructions on work outside the lanes'
// reach, not in fixed costs: with blocks of 8 prims and of 32 centers
// culled against a warp's hull, a warp ran 6.9 (K1) and 8.0 (K2) prims
// for every prim in a lane's reach and 9.0 centers for every center in
// reach, at some 50 instructions a prim and 30-40 a center, while the whole grid
// with every ray dead took 0.03 ms and the grid, the copy into shared
// memory and the entry eval together 0.05 (K1) and 0.13 ms (K2) of 0.81
// and 1.84 ms. With the culls below a warp runs 1.2 prims and 1.15
// centers per one in reach and both kernels take under half their time;
// what is left is the latency of a patch's serial chain of evals (the
// instruction slots of the prims and centers that run are about a sixth
// of the time) and lanes of a warp that are done while others march.
// Design:
//   * one ray a thread and a warp on a patch of 32 rays: of a 256-ray tile
//     (a 16x16 pixel block) an 8x4 pixel patch, so its rays end together
//     more often and its hull is tight. No step of the march is CTA-wide:
//     a ray's result does not depend on its neighbours in any mode (K2
//     refreshes the rest-point model of a lane only while that lane
//     marches), so every warp marches alone;
//   * CTAs stay resident (three an SM in K2, four in K1 and K4; see
//     default_ctas).
//     Each copies the tables once, as one 16-byte-aligned block that the
//     host laid out in the shared-memory layout (cp.async, in flight
//     while the CTA writes its share of the misses: a ray that starts
//     dead gets t_exit and no hit in a first pass over all rays); then
//     its warps take patches off the host's list of patches with a live
//     ray through one atomic counter until the list is empty. Which warp
//     takes which patch changes no result;
//   * the prim cull is per warp, per eval and per prim: the hull of the
//     points whose value is needed (six warp reductions on integer keys),
//     each lane tests one prim's support box against it, a ballot per 32
//     prims, and the warp walks the set bits. Words whose prims the
//     tile's static flags rule out are skipped. The cull is exact
//     (compact support: a skipped prim adds exactly 0) and the sum keeps
//     its order, a partial sum per block of 8, so hits and roots are those
//     of the block cull, bit for bit;
//   * K2's center cull is per center: each lane tests whether one center
//     lies within sigma of the hull of the refreshing lanes' estimates,
//     a ballot per block of 32 (blocks the tile's static flags rule out
//     are skipped), partial sums per block as in the plain version. The
//     loop takes its square root as one special-function instruction;
//   * tables are laid out for wide loads (a prim row is six 16-byte
//     loads, a center with its weights one of 16 and one of 8): a scalar
//     load costs an instruction slot like a vector one. K4's center loop
//     is paced by the bytes shared memory hands to each lane, so a center
//     takes its 24 bytes and no padding;
//   * K4 computes |x - c| directly, its square root as one
//     special-function instruction (sqrt.approx): the TPU kernel's
//     recentred quadratic expansion exists for its matrix unit and buys
//     nothing here.
// A counting build of each mode (the `counts` argument) adds up the needed
// lane-evals, 32 for every warp-eval that ran, 32 for every prim and
// center a warp evaluated and 32 for every warp pull-back; the shipped
// path does not count.
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

constexpr int kPrimBlock = 8;   // prims per Morton block (a partial sum)
constexpr int kCenBlock = 32;   // centers per block (a flag, a partial sum)
constexpr int kThreads = 256;   // eight warps a CTA, each on its own patch
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kRest = 0, kWendland = 1, kBiharmonic = 2 };
// Counting build: needed lane-evals, lanes of the warp-evals that ran,
// lane-prims run, lanes of the warp pull-backs that ran, lane-centers run.
enum Counter { kNeeded = 0, kLanesRun, kPrimsRun, kPullLanesRun, kCentersRun };

// CTAs an SM the kernel of each mode is compiled for (the register budget
// of __launch_bounds__: 64 registers a thread at four, 80 at three, 128 at
// two). K2 is also built for two, which the caller can ask for, so that
// its choice of three can be measured again.
__host__ __device__ constexpr int default_ctas(int mode) {
  return mode == 1 /* kWendland */ ? 3 : 4;
}
constexpr int kMeasuredCtas = 2;  // K2's second build

struct Args {
  const float* rays;       // [9, n] ro xyz, rd xyz, t_enter, t_exit, alive0
  const int* live;         // [tiles, n_blocks] blocks a tile may evaluate
  const float* tile_rows;  // [tiles, 4] inv_stretch, shrink, slack, L
  const float4* tables;    // the shared-memory image, see Layout
  const int* work;         // patches with a live ray, in order
  const int* n_work;       // [1] how many
  int* next;               // [1] zeroed: the next entry of `work` to take
  float* t_out;            // [n]
  float* hit_out;          // [n]
  unsigned long long* counts;  // counting build: see Counter
  int n_rays, tile, n_prims, n_blocks, dyn_cull;
  float iso, r_iso, base_step;
  int max_steps, bisect_steps;
  int n_centers;           // deformed modes
  const int* clive;        // Wendland: [tiles, n_centers / kCenBlock]
  int k_refresh;
  float sigma, inv_sigma;
  int fp_iters;            // biharmonic
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The tables every patch reads, in 4-byte words; render/tile_trace.py
// `pack_tables` lays them out in device memory in this order, so a CTA
// copies one straight block. Every table starts on a 16-byte boundary.
// Boxes are lo xyz _ | hi xyz _; a center with its weights takes 24 bytes,
// c xyz w_x in `centers` and w_y w_z in `weights`. After the tables each
// warp has pw + cw words for its patch's static flags.
struct Layout {
  int prims, pboxes, centers, weights, waff;
  int total;        // words of the copied tables
  int pw, cw;       // per warp: prim flag words, center-block flag words
};

__host__ __device__ inline Layout make_layout(int n_prims, int n_centers,
                                              int mode) {
  Layout L{};
  int o = 0;
  L.prims = o;   o += n_prims * kPrimRow;
  L.pboxes = o;  o += n_prims * 8;
  if (mode != kRest) {
    L.centers = o;  o += n_centers * 4;
    L.weights = o;  o += round4(n_centers * 2);
    L.waff = o;     o += 12;
  }
  L.total = o;
  L.pw = (n_prims + 31) >> 5;
  L.cw = mode == kWendland ? (n_centers / kCenBlock + 31) >> 5 : 0;
  return L;
}

struct Shared {
  const float* prims;
  const float4* pboxes;
  const float4* centers;  // c xyz, w_x
  const float2* weights;  // w_y, w_z
  const float* waff;
  unsigned* pmask;  // this warp's patch: prims its tile may evaluate
  unsigned* cmask;  // this warp's patch: center blocks its tile may reach
  int pw, cw;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Linear rest-point model of one lane: rest point (xr, yr, zr) at the last
// refresh tr and slope v; between refreshes x(t) = x_r + (t - t_r) v.
struct Carry {
  float xr, yr, zr, vx, vy, vz, tr;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}

template <bool kCount>
__device__ __forceinline__ void count_add(const Args& a, int which,
                                          unsigned long long v) {
  if (kCount && (threadIdx.x & 31) == 0) atomicAdd(a.counts + which, v);
}

// Rest field minus iso at a point, for the lanes with `need` set (the
// others get no value). Of the prims the patch's tile may evaluate, those
// whose support box meets the hull of the needed lanes' points are
// evaluated; the sum keeps the plain version's order (a partial sum per
// block of kPrimBlock, blocks in order). Every lane of the warp must call
// it.
template <bool kCount>
__device__ float field_rest(const Args& a, const Shared& s, float x, float y,
                            float z, bool need) {
  if (!__any_sync(kFull, need)) return 0.0f;
  const int lane = threadIdx.x & 31;
  Hull h{};
  if (a.dyn_cull) h = warp_hull(need, x, y, z);
  float f = 0.0f;
  for (int c = 0; c < s.pw; ++c) {
    unsigned mask = s.pmask[c];
    if (mask == 0) continue;
    if (a.dyn_cull) {
      const int p = 32 * c + lane;
      const bool ok = ((mask >> lane) & 1u) &&
                      hull_meets(h, s.pboxes[2 * p], s.pboxes[2 * p + 1]);
      mask = __ballot_sync(kFull, ok);
    }
    count_add<kCount>(a, kPrimsRun, 32ull * __popc(mask));
    if (!need) continue;
#pragma unroll
    for (int q = 0; q < 32 / kPrimBlock; ++q) {
      unsigned m = (mask >> (kPrimBlock * q)) & ((1u << kPrimBlock) - 1u);
      if (m == 0) continue;
      const float* pb = s.prims + (32 * c + kPrimBlock * q) * kPrimRow;
      float bs = 0.0f;
      while (m) {
        bs += prim_field(pb + (__ffs(m) - 1) * kPrimRow, x, y, z);
        m &= m - 1;
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

// One special-function instruction (2 ulp); 0 at 0, so |x - c| needs no
// floor (the plain biharmonic version's 1e-24 floor on d2 moves d by at
// most 1e-12).
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One Wendland fixed-point pull-back iteration x <- y - u(x) at the
// estimate (xx, yy, zz) for the deformed point (px, py, pz). Of the blocks
// the patch's tile may reach, each lane tests one center: it runs where it
// lies within sigma of the hull of the pmask lanes' estimates (farther away
// it adds exactly 0 to every one of them). The sum keeps the plain
// version's order, a partial sum per block of kCenBlock. Only pmask lanes
// use the result. Every lane of the warp must call it.
template <bool kCount>
__device__ void pull_one(const Args& a, const Shared& s, float xx, float yy,
                         float zz, float px, float py, float pz, bool pmask,
                         float& ox, float& oy, float& oz) {
  static_assert(kCenBlock == 32, "one center of a block per lane");
  const int lane = threadIdx.x & 31;
  const Hull h = warp_hull(pmask, xx, yy, zz);
  const float reach = a.sigma + fb::kHullEps;
  count_add<kCount>(a, kPullLanesRun, 32ull);
  float ux, uy, uz;
  affine_tail(s.waff, xx, yy, zz, ux, uy, uz);
  const int n_cb = a.n_centers / kCenBlock;
  for (int b = 0; b < n_cb; ++b) {
    if (!((s.cmask[b >> 5] >> (b & 31)) & 1u)) continue;
    const float4 mine = s.centers[kCenBlock * b + lane];
    const float ex = fmaxf(fmaxf(h.lo[0] - mine.x, mine.x - h.hi[0]), 0.0f);
    const float ey = fmaxf(fmaxf(h.lo[1] - mine.y, mine.y - h.hi[1]), 0.0f);
    const float ez = fmaxf(fmaxf(h.lo[2] - mine.z, mine.z - h.hi[2]), 0.0f);
    unsigned m =
        __ballot_sync(kFull, ex * ex + ey * ey + ez * ez <= reach * reach);
    count_add<kCount>(a, kCentersRun, 32ull * __popc(m));
    if (!pmask) continue;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    while (m) {
      const int j = kCenBlock * b + __ffs(m) - 1;
      m &= m - 1;
      const float4 cc = s.centers[j];
      const float2 w = s.weights[j];
      const float dx = xx - cc.x, dy = yy - cc.y, dz = zz - cc.z;
      const float d = sqrt_approx(dx * dx + dy * dy + dz * dz);
      const float tt = fminf(d * a.inv_sigma, 1.0f);
      const float omt = 1.0f - tt;
      const float o2 = omt * omt;
      const float ph = o2 * o2 * (4.0f * tt + 1.0f);  // Wendland C2
      sx += cc.w * ph;
      sy += w.x * ph;
      sz += w.y * ph;
    }
    ux += sx;
    uy += sy;
    uz += sz;
  }
  ox = px - ux;
  oy = py - uy;
  oz = pz - uz;
}

// Deformed field minus iso at ray parameter t: on a refresh, pull the
// model's estimate back once and refit the slope from the refresh-to-
// refresh secant (pmask lanes only); then evaluate the rest field at the
// model's point.
template <bool kCount>
__device__ float eval_wendland(const Args& a, const Shared& s, const Ray& r,
                               float t, Carry& c, bool refresh, bool pmask,
                               bool need) {
  if (refresh && __any_sync(kFull, pmask)) {
    const float adv = t - c.tr;
    float x2, y2, z2;
    pull_one<kCount>(a, s, c.xr + adv * c.vx, c.yr + adv * c.vy,
                     c.zr + adv * c.vz, r.ox + t * r.dx, r.oy + t * r.dy,
                     r.oz + t * r.dz, pmask, x2, y2, z2);
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
  return field_rest<kCount>(a, s, c.xr + a2 * c.vx, c.yr + a2 * c.vy,
                            c.zr + a2 * c.vz, need);
}

// Biharmonic-deformed field minus iso at ray parameter t: fp_iters
// fixed-point iterations from the deformed point over every center, then
// the rest field at the pulled-back point. Only lanes that need the value
// pull back. The center loop is the kernel's whole cost on a frame whose
// rays march mostly through empty space, and it is paced by the bytes that
// shared memory hands to every lane: 24 per center.
template <bool kCount>
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
  return field_rest<kCount>(a, s, xx, yy, zz, need);
}

// Field minus iso at ray parameter t for the lanes with `need` set. Every
// lane of the warp must call it.
template <int kMode, bool kCount>
__device__ __forceinline__ float eval_at(const Args& a, const Shared& s,
                                         const Ray& r, float t, Carry& c,
                                         bool refresh, bool pmask, bool need) {
  if (kCount) {
    const unsigned m = __ballot_sync(kFull, need);
    if (m != 0) {
      count_add<kCount>(a, kNeeded, __popc(m));
      count_add<kCount>(a, kLanesRun, 32ull);
    }
  }
  if (kMode == kWendland) {
    return eval_wendland<kCount>(a, s, r, t, c, refresh, pmask, need);
  }
  if (kMode == kBiharmonic) return eval_biharmonic<kCount>(a, s, r, t, need);
  return field_rest<kCount>(a, s, r.ox + t * r.dx, r.oy + t * r.dy,
                            r.oz + t * r.dz, need);
}

// March and refine the 32 rays of one patch: lane's ray is g of tile `tile`.
// Rays that start dead were written by the kernel's first pass.
template <int kMode, bool kCount>
__device__ void trace_patch(const Args& a, const Shared& s, int tile, int g) {
  const int n = a.n_rays;
  const bool alive0 = a.rays[8 * n + g] > 0.0f;
  const float t_exit = a.rays[7 * n + g];
  const float t_enter = a.rays[6 * n + g];
  const Ray r{a.rays[g], a.rays[n + g], a.rays[2 * n + g],
              a.rays[3 * n + g], a.rays[4 * n + g], a.rays[5 * n + g]};
  const float4 row = reinterpret_cast<const float4*>(a.tile_rows)[tile];
  const float inv_stretch = row.x, shrink = row.y, slack = row.z,
              ldrift = row.w;

  Carry c{r.ox + t_enter * r.dx, r.oy + t_enter * r.dy, r.oz + t_enter * r.dz,
          r.dx, r.dy, r.dz, t_enter};
  const float f0 =
      eval_at<kMode, kCount>(a, s, r, t_enter, c, true, alive0, alive0);
  float t = t_enter, f = f0, t_prev = t_enter, f_prev = f0;
  bool found = alive0 && f0 >= 0.0f;
  bool alive = alive0 && f0 < 0.0f;

  // `it` counts sub-steps; the loop test runs once per iteration and is the
  // warp's own. In K2 the first sub-step of an iteration refreshes the
  // model of the lanes still marching.
  const int n_sub = kMode == kWendland ? a.k_refresh : 2;
  int it = 0;
  while (it < a.max_steps && __any_sync(kFull, alive)) {
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
          eval_at<kMode, kCount>(a, s, r, t_new, c, k == 0, alive, alive);
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
  if (alive0) {
    const float denom = fb - fa;
    const float t_sec =
        ta - fa * (tb - ta) / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
    const float t_root = fabsf(denom) < 1e-9f ? 0.5f * (ta + tb) : t_sec;
    a.t_out[g] = found ? t_root : t_exit;
    a.hit_out[g] = found ? 1.0f : 0.0f;
  }
}

template <int kMode, bool kCount, int kCtas>
__global__ void __launch_bounds__(kThreads, kCtas)
    trace_additive_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n = a.n_rays;
  const Layout L = make_layout(a.n_prims, a.n_centers, kMode);

  // The tables, once for the CTA's whole life, in flight while the first
  // pass runs.
  for (int i = tid; i < L.total / 4; i += kThreads) {
    cp_async16(smem4 + i, a.tables + i);
  }

  // First pass, all CTAs together over all rays: a ray that starts dead
  // misses. n is a multiple of 32, so rows split into aligned float4s.
  {
    const float4* ex4 = reinterpret_cast<const float4*>(a.rays + 7 * n);
    const float4* al4 = reinterpret_cast<const float4*>(a.rays + 8 * n);
    for (int i = blockIdx.x * kThreads + tid; i < n / 4;
         i += gridDim.x * kThreads) {
      const float4 al = al4[i];
      const float4 ex = ex4[i];
      if (!(al.x > 0.0f)) { a.t_out[4 * i] = ex.x; a.hit_out[4 * i] = 0.0f; }
      if (!(al.y > 0.0f)) { a.t_out[4 * i + 1] = ex.y; a.hit_out[4 * i + 1] = 0.0f; }
      if (!(al.z > 0.0f)) { a.t_out[4 * i + 2] = ex.z; a.hit_out[4 * i + 2] = 0.0f; }
      if (!(al.w > 0.0f)) { a.t_out[4 * i + 3] = ex.w; a.hit_out[4 * i + 3] = 0.0f; }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  unsigned* flags = reinterpret_cast<unsigned*>(smem + L.total) +
                    (tid >> 5) * (L.pw + L.cw);
  const Shared s{smem + L.prims,
                 reinterpret_cast<const float4*>(smem + L.pboxes),
                 reinterpret_cast<const float4*>(smem + L.centers),
                 reinterpret_cast<const float2*>(smem + L.weights),
                 smem + L.waff,
                 flags, flags + L.pw, L.pw, L.cw};

  // Each warp takes patches of 32 rays off the list until it is empty. A
  // patch of a 256-ray tile (a 16x16 pixel block in row-major order) is
  // the 8x4 pixel patch at column 8 (w & 1), row 4 (w >> 1); of any other
  // tile, 32 rays in a row.
  const int n_work = *a.n_work;
  const int per_tile = a.tile >> 5;
  const int n_cb = a.n_centers / kCenBlock;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(a.next, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= n_work) break;
    const int patch = a.work[item];
    const int tile = patch / per_tile;
    const int w = patch - tile * per_tile;
    int slot = 32 * w + lane;
    if (a.tile == 256) {
      slot = ((w >> 1) * 4 + (lane >> 3)) * 16 + (w & 1) * 8 + (lane & 7);
    }
    // The tile's static flags as this warp's bit masks.
    for (int c = 0; c < L.pw; ++c) {
      const int p = 32 * c + lane;
      const bool ok =
          p < a.n_prims && a.live[tile * a.n_blocks + p / kPrimBlock] != 0;
      const unsigned m = __ballot_sync(kFull, ok);
      if (lane == 0) s.pmask[c] = m;
    }
    for (int c = 0; c < L.cw; ++c) {
      const int b = 32 * c + lane;
      const bool ok = b < n_cb && a.clive[tile * n_cb + b] != 0;
      const unsigned m = __ballot_sync(kFull, ok);
      if (lane == 0) s.cmask[c] = m;
    }
    __syncwarp();
    trace_patch<kMode, kCount>(a, s, tile, tile * a.tile + slot);
    __syncwarp();  // the next patch rewrites the flags
  }
}

// Launch as many CTAs as stay resident (or as there are patches of eight
// warps' work, if fewer).
template <int kMode, bool kCount, int kCtas>
int launch_one(const Args& a, void* stream) {
  const auto kernel = trace_additive_kernel<kMode, kCount, kCtas>;
  const Layout L = make_layout(a.n_prims, a.n_centers, kMode);
  const size_t bytes =
      sizeof(float) * (L.total + (kThreads / 32) * (L.pw + L.cw));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (per_sm > kCtas) per_sm = kCtas;
  const int patches = a.n_rays / 32;
  int grid = sms * per_sm;
  const int wanted = (patches + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > wanted) grid = wanted;
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch(const Args& a, bool two_ctas, void* stream) {
  if (two_ctas && (kMode != kWendland || a.counts != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n_rays == 0) return 0;
  if (a.counts != nullptr) {
    return launch_one<kMode, true, default_ctas(kMode)>(a, stream);
  }
  if constexpr (kMode == kWendland) {
    if (two_ctas) return launch_one<kMode, false, kMeasuredCtas>(a, stream);
  }
  return launch_one<kMode, false, default_ctas(kMode)>(a, stream);
}

}  // namespace

// The additive tile trace in mode 0 (K1 rest), 1 (K2 Wendland) or 2 (K4
// biharmonic). Returns a cudaError_t code (0 on success). `counts` is
// null, or five zeroed 64-bit counters for the counting build (Counter).
// `two_ctas` non-zero picks K2's build for two CTAs an SM (mode 1 without
// `counts` only; anything else is cudaErrorInvalidValue).
extern "C" int fb_trace_additive(
    int mode, const float* rays, const int* live, const float* tile_rows,
    const float* tables, const int* work, const int* n_work, int* next,
    float* t_out, float* hit_out, unsigned long long* counts, int n_rays,
    int tile, int n_prims, int n_blocks, int dyn_cull, float iso, float r_iso,
    float base_step, int max_steps, int bisect_steps, const int* clive,
    int n_centers, float sigma, float inv_sigma, int k_refresh, int fp_iters,
    int two_ctas, void* stream) {
  Args a{};
  a.rays = rays;
  a.live = live;
  a.tile_rows = tile_rows;
  a.tables = reinterpret_cast<const float4*>(tables);
  a.work = work;
  a.n_work = n_work;
  a.next = next;
  a.t_out = t_out;
  a.hit_out = hit_out;
  a.counts = counts;
  a.n_rays = n_rays;
  a.tile = tile;
  a.n_prims = n_prims;
  a.n_blocks = n_blocks;
  a.dyn_cull = dyn_cull;
  a.iso = iso;
  a.r_iso = r_iso;
  a.base_step = base_step;
  a.max_steps = max_steps;
  a.bisect_steps = bisect_steps;
  a.clive = clive;
  a.n_centers = mode == kRest ? 0 : n_centers;
  a.sigma = sigma;
  a.inv_sigma = inv_sigma;
  a.k_refresh = k_refresh;
  a.fp_iters = fp_iters;
  switch (mode) {
    case kRest: return launch<kRest>(a, two_ctas != 0, stream);
    case kWendland: return launch<kWendland>(a, two_ctas != 0, stream);
    case kBiharmonic: return launch<kBiharmonic>(a, two_ctas != 0, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
