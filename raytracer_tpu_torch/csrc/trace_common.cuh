// Pieces shared by the trace kernels (cluster_trace.cu, iseg_trace.cu,
// icluster_trace.cu): the Pallas kernels' clamped reciprocal, the slab
// test's entry key, and the Moller-Trumbore test on a stored basis. Each
// is the arithmetic of the plain PyTorch versions (ops/cluster_trace.py:
// rcp, slab_keys, _mt), operation for operation; built with -fmad=false,
// every multiply and add rounds on its own, so the kernels agree with them
// bit for bit. The wrappers build with -I csrc and hash this header with
// the kernel sources, so an edit here rebuilds every kernel.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rt {

constexpr float kTmax = 1e12f;    // MIRO_TMAX
constexpr float kTiny = 1e-20f;   // the Pallas kernels' reciprocal clamp
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float rcp_clamped(float v) {
  const float x = fabsf(v) < kTiny ? (v < 0.f ? -kTiny : kTiny) : v;
  return 1.0f / x;
}

// Entry key max(near, 0) of a ray against the box in column `j` of six rows
// of stride `n` (lo x, y, z, hi x, y, z), or +inf when the slab test fails.
__device__ __forceinline__ float slab_key(const float* __restrict__ bb,
                                          int n, int j, float ox, float oy,
                                          float oz, float ix, float iy,
                                          float iz, float tmin, float tmax) {
  const float tx0 = (bb[j] - ox) * ix, tx1 = (bb[3 * n + j] - ox) * ix;
  const float ty0 = (bb[n + j] - oy) * iy, ty1 = (bb[4 * n + j] - oy) * iy;
  const float tz0 = (bb[2 * n + j] - oz) * iz, tz1 = (bb[5 * n + j] - oz) * iz;
  const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fminf(tz0, tz1));
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  if (!(tnear <= tfar && tfar >= tmin && tnear <= tmax)) return CUDART_INF_F;
  return fmaxf(tnear, 0.f);
}

// Moller-Trumbore of the ray (o, d) against the triangle p + a e1 + b e2 ->
// whether it hits at tmin <= t < best_t inside the triangle; t, a and b are
// written either way.
__device__ __forceinline__ bool mt_hit(float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float px, float py, float pz,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       float tmin, float best_t, float& t,
                                       float& a, float& b) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = 1.0f / det;
  const float tvx = ox - px, tvy = oy - py, tvz = oz - pz;
  a = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  b = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return a >= 0.f && a <= 1.f && b >= 0.f && a + b <= 1.f && det != 0.f &&
         t >= tmin && t < best_t;
}

}  // namespace rt
