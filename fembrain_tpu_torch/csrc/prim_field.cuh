// Device helpers shared by the tile-trace kernels (trace_additive.cu,
// trace_general.cu): the Wyvill field of one packed prim row, the
// sphere-trace step table, and the warp-wide hull of the lanes' points
// that both kernels cull against.
//
// Counterpart of fembrain_tpu/ops/field.py `rows_prim_fields` (the typed
// skeleton distances) and fembrain_tpu/render/sphere_trace.py
// `support_radius_bound`; the plain PyTorch versions are in
// fembrain_tpu_torch/ops/field.py and render/sphere_trace.py.
//
// A prim row is read from shared memory as six 16-byte loads: every lane
// of a warp reads the same row, and a scalar load costs an instruction
// slot like a vector one. One POINT row is 41 warp instructions in the
// additive kernel's walk (loads, transform and type test 26, distance 6,
// Wyvill 4, loop 5), a CYLINDER row some 70 (SASS for sm_90a): a kernel
// that evaluates prims outside its lanes' reach pays in instruction slots, so
// both kernels cull per prim against the hull below before they walk.
#pragma once

#include <cuda_runtime.h>

namespace fb {

constexpr int kPrimRow = 24;  // m[3][4], pos[3], dir[3], res[4], type, aux
constexpr float kBig = 10.0f;  // squared distance of prims with no branch

enum PrimType {
  kPoint = 0, kLine = 1, kCylinder = 2, kDisc = 3, kRing = 4, kCube = 5,
  kTriangle = 6, kQuadricPoint = 7,
};

__device__ __forceinline__ float wyvill(float dd) {
  const float t = fmaxf(0.0f, 1.0f - dd);
  return t * t * t;
}

__device__ __forceinline__ float safe_div(float num, float den) {
  const float eps = 1e-12f;
  return num / (fabsf(den) < eps ? (den < 0.0f ? -eps : eps) : den);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// x * rsqrt(x) for x > 0: one special-function instruction and a multiply
// in place of the IEEE square root's correction sequence (2 ulp).
__device__ __forceinline__ float sqrt_fast(float x) { return x * rsqrtf(x); }

__device__ inline float dist2_triangle(float vx, float vy, float vz,
                                       float ax, float ay, float az,
                                       float bx, float by, float bz,
                                       float cx, float cy, float cz) {
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float d1 = dot3(abx, aby, abz, vx - ax, vy - ay, vz - az);
  const float d2 = dot3(acx, acy, acz, vx - ax, vy - ay, vz - az);
  const float d3 = dot3(abx, aby, abz, vx - bx, vy - by, vz - bz);
  const float d4 = dot3(acx, acy, acz, vx - bx, vy - by, vz - bz);
  const float d5 = dot3(abx, aby, abz, vx - cx, vy - cy, vz - cz);
  const float d6 = dot3(acx, acy, acz, vx - cx, vy - cy, vz - cz);
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float denom = va + vb + vc;
  const float v = safe_div(vb, denom);
  const float w = safe_div(vc, denom);
  float qx = ax + v * abx + w * acx;
  float qy = ay + v * aby + w * acy;
  float qz = az + v * abz + w * acz;
  const float t_ab = fminf(fmaxf(safe_div(d1, d1 - d3), 0.0f), 1.0f);
  const float t_ac = fminf(fmaxf(safe_div(d2, d2 - d6), 0.0f), 1.0f);
  const float t_bc =
      fminf(fmaxf(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0f), 1.0f);
  const bool in_ab = (vc <= 0.0f) && (d1 >= 0.0f) && (d3 <= 0.0f);
  const bool in_ac = (vb <= 0.0f) && (d2 >= 0.0f) && (d6 <= 0.0f);
  const bool in_bc = (va <= 0.0f) && ((d4 - d3) >= 0.0f) && ((d5 - d6) >= 0.0f);
  const bool at_a = (d1 <= 0.0f) && (d2 <= 0.0f);
  const bool at_b = (d3 >= 0.0f) && (d4 <= d3);
  const bool at_c = (d6 >= 0.0f) && (d5 <= d6);
  // Later cases override earlier ones, in the reference's order.
  if (in_bc) {
    qx = bx + t_bc * (cx - bx); qy = by + t_bc * (cy - by); qz = bz + t_bc * (cz - bz);
  }
  if (in_ac) { qx = ax + t_ac * acx; qy = ay + t_ac * acy; qz = az + t_ac * acz; }
  if (in_ab) { qx = ax + t_ab * abx; qy = ay + t_ab * aby; qz = az + t_ab * abz; }
  if (at_c) { qx = cx; qy = cy; qz = cz; }
  if (at_b) { qx = bx; qy = by; qz = bz; }
  if (at_a) { qx = ax; qy = ay; qz = az; }
  const float ex = vx - qx, ey = vy - qy, ez = vz - qz;
  return dot3(ex, ey, ez, ex, ey, ez);
}

// Wyvill field of one packed prim row at a point (world coordinates for
// the additive kernel, warped coordinates for the general one). `p` is
// 16-byte aligned. Rows carry the type the evaluator should use: in the
// additive kernel, points that share a block with lines or cylinders
// arrive as degenerate lines (dir = pos) or cylinders (dir = 0, r = h = 0).
__device__ inline float prim_field(const float* p, float x, float y,
                                   float z) {
  const float4* row = reinterpret_cast<const float4*>(p);
  const float4 m0 = row[0], m1 = row[1], m2 = row[2];
  const float4 r3 = row[3], r4 = row[4], r5 = row[5];
  const float vx = m0.x * x + m0.y * y + m0.z * z + m0.w;
  const float vy = m1.x * x + m1.y * y + m1.z * z + m1.w;
  const float vz = m2.x * x + m2.y * y + m2.z * z + m2.w;
  const float px = r3.x, py = r3.y, pz = r3.z;
  const float qx = r3.w, qy = r4.x, qz = r4.y;
  const float res0 = r4.z, res1 = r4.w, res2 = r5.x;
  const int type = static_cast<int>(r5.z);
  // The commonest type ahead of the switch: a compare and a branch where
  // the jump table costs a constant load and an indirect branch.
  if (type == kPoint) {
    const float ex = px - vx, ey = py - vy, ez = pz - vz;
    return wyvill(dot3(ex, ey, ez, ex, ey, ez));
  }
  float d2 = kBig;
  switch (type) {
    case kLine: {
      const float lx = qx - px, ly = qy - py, lz = qz - pz;
      const float dd = dot3(lx, ly, lz, lx, ly, lz);
      const float t = safe_div(dot3(vx - px, vy - py, vz - pz, lx, ly, lz), dd);
      const float ex = vx - (px + t * lx), ey = vy - (py + t * ly),
                  ez = vz - (pz + t * lz);
      d2 = dot3(ex, ey, ez, ex, ey, ez);
      break;
    }
    case kCylinder: {
      const float sx = vx - px, sy = vy - py, sz = vz - pz;
      float h = dot3(sx, sy, sz, qx, qy, qz);
      const float pp = dot3(sx, sy, sz, sx, sy, sz);
      const float r = fmaxf(0.0f, sqrt_fast(fmaxf(pp - h * h, 1e-20f)) - res0);
      h = h > 0.0f ? fmaxf(0.0f, h - res1) : h;
      d2 = r * r + h * h;
      break;
    }
    case kDisc:
    case kRing: {
      const float rad = res0;
      const float sx = vx - px, sy = vy - py, sz = vz - pz;
      const float dn = dot3(sx, sy, sz, qx, qy, qz);
      const float ix = sx - dn * qx, iy = sy - dn * qy, iz = sz - dn * qz;
      const float len2 = dot3(ix, iy, iz, ix, iy, iz);
      const float dd = dot3(sx, sy, sz, sx, sy, sz);
      const float inv_len = rsqrtf(len2 < 1e-24f ? 1.0f : len2);
      const float ex = rad * ix * inv_len - sx, ey = rad * iy * inv_len - sy,
                  ez = rad * iz * inv_len - sz;
      const float edge2 = dot3(ex, ey, ez, ex, ey, ez);
      if (type == kDisc) {
        d2 = len2 <= rad * rad ? fabsf(dd - len2) : edge2;
      } else {
        d2 = len2 < 1e-24f ? rad * rad + dd : edge2;
      }
      break;
    }
    case kCube: {
      const float side = res0;
      const float ex = fmaxf(fabsf(vx - px) - side, 0.0f);
      const float ey = fmaxf(fabsf(vy - py) - side, 0.0f);
      const float ez = fmaxf(fabsf(vz - pz) - side, 0.0f);
      d2 = 0.0f + ex * ex + ey * ey + ez * ez;
      break;
    }
    case kTriangle:
      d2 = dist2_triangle(vx, vy, vz, px, py, pz, qx, qy, qz, res0, res1,
                          res2);
      break;
    case kQuadricPoint: {
      // Polynomial inside the support radius dir.z, Wyvill outside.
      const float ex = vx - px, ey = vy - py, ez = vz - pz;
      const float dd = dot3(ex, ey, ez, ex, ey, ez);
      return qz > dd ? dd * dd * res0 + dd * res1 + res2 : wyvill(dd);
    }
    default:
      break;
  }
  return wyvill(d2);
}

// Piecewise-constant lower bound on r(f) = sqrt(1 - f^(1/3)), shared with
// render/sphere_trace.py support_radius_bound.
__device__ __forceinline__ float support_radius_bound(float fv) {
  float r = 0.4542f;
  if (fv <= 0.30f) r = 0.5749f;
  if (fv <= 0.20f) r = 0.6444f;
  if (fv <= 0.15f) r = 0.6846f;
  if (fv <= 0.10f) r = 0.7320f;
  if (fv <= 0.05f) r = 0.7947f;
  if (fv <= 0.02f) r = 0.8536f;
  if (fv <= 0.005f) r = 0.9105f;
  if (fv <= 0.001f) r = 0.9487f;
  if (fv <= 0.0001f) r = 0.9765f;
  return r;
}

// Bounding box of a warp's points, for culls that are uniform across the
// warp. Floats are reduced as order-preserving signed integer keys, so
// each of the six extremes is one warp reduction instruction.
struct Hull {
  float lo[3], hi[3];
};

__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Hull of (x, y, z) over the lanes with m set (1e30 / -1e30 when none is).
// Every lane of the warp must call it.
__device__ __forceinline__ Hull warp_hull(bool m, float x, float y, float z) {
  const float p[3] = {x, y, z};
  Hull h;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.lo[k] = key_float(
        __reduce_min_sync(0xffffffffu, float_key(m ? p[k] : 1e30f)));
    h.hi[k] = key_float(
        __reduce_max_sync(0xffffffffu, float_key(m ? p[k] : -1e30f)));
  }
  return h;
}

constexpr float kHullEps = 1e-4f;  // slack of the hull/box overlap test

// Whether the hull meets the box stored as lo xyz _, hi xyz _.
__device__ __forceinline__ bool hull_meets(const Hull& h, float4 lo,
                                           float4 hi) {
  return h.lo[0] <= hi.x + kHullEps && h.hi[0] >= lo.x - kHullEps &&
         h.lo[1] <= hi.y + kHullEps && h.hi[1] >= lo.y - kHullEps &&
         h.lo[2] <= hi.z + kHullEps && h.hi[2] >= lo.z - kHullEps;
}

}  // namespace fb
