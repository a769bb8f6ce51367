// Brute-force Moller-Trumbore sweep for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/mt_kernel.py
// (mt_trace_pallas, bodies _kernel and _mt_block): every ray against every
// triangle, nearest hit. It follows the rule of the plain PyTorch version
// (raytracer_tpu_torch/ops/mt_trace.py), so the two agree bit for bit: the
// triangles are swept in id order and a hit replaces the running best only
// with a strictly smaller t, tested against min(tmax, best t), so an exact
// tie goes to the lowest triangle id (the Pallas kernel's first-lane argmin
// inside a 512-triangle tile and strict `<` across tiles give the same).
// A triangle hits when det != 0, 0 <= a, 0 <= b, a <= 1, a + b <= 1,
// tmin <= t < bound and its valid flag is set. Built with -fmad=false and
// every sum written in _mt_block's order (e0 = p1 - p0, inv_det = 1 / det,
// a = dot(tvec, pvec) * inv_det, each dot summed x, y, z), every multiply
// and add rounds on its own as in the plain version. A ray whose interval
// [tmin, tmax) is empty (a dead ray: tmax <= 0 < tmin) never hits, and a
// block of such rays leaves at once. A miss writes t = MIRO_TMAX, tri = -1,
// a = b = 0; a hit writes the winning triangle's own a and b.
//
// Layout: each block stages kTile triangles at a time in shared memory as
// nine SoA float rows (p0, e0 = p1 - p0, e1 = p2 - p0; the edges are formed
// once per triangle, with the same subtraction _mt_block does per pair) and
// the valid flag; every thread then reads the same triangle at once, a
// broadcast.
//
// What bounds it on the H100: operations. Each (ray, triangle) pair costs
// about 45 float32 operations (no multiply-add contraction) and ten shared
// loads, and nothing else: the triangles of a tile are read once per block.
// The work is every live ray times every triangle, which is why the JAX
// package keeps this sweep off the main path. A faster version would give
// each thread several rays, so that one shared load feeds more arithmetic,
// and stage the triangles as float4 rows.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // rays per block (the Pallas RAY_TILE)
constexpr int kTile = 512;        // triangles per staged tile (TRI_TILE)
constexpr float kBig = 3.0e38f;   // the Pallas kernel's running-best start
constexpr float kTmax = 1e12f;    // MIRO_TMAX

__global__ void __launch_bounds__(kThreads)
mt_trace_kernel(const float* __restrict__ p0,       // (T, 3)
                const float* __restrict__ p1,       // (T, 3)
                const float* __restrict__ p2,       // (T, 3)
                const int* __restrict__ valid,      // (T,)
                int T,
                const float* __restrict__ orig,     // (R, 3)
                const float* __restrict__ dir,      // (R, 3)
                const float* __restrict__ tmin_in,  // (R,)
                const float* __restrict__ tmax_in,  // (R,)
                int R,
                float* __restrict__ t_out,          // (R,)
                int* __restrict__ tri_out,          // (R,)
                float* __restrict__ a_out,          // (R,)
                float* __restrict__ b_out) {        // (R,)
  __shared__ float s_tri[9][kTile];   // p0, e0, e1: x, y, z rows (18 KB)
  __shared__ int s_valid[kTile];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = -1.f;   // padding threads are dead rays
  if (r < R) {
    ox = orig[3 * r]; oy = orig[3 * r + 1]; oz = orig[3 * r + 2];
    dx = dir[3 * r]; dy = dir[3 * r + 1]; dz = dir[3 * r + 2];
    tmin = tmin_in[r];
    tmax = tmax_in[r];
  }
  const bool live = tmin < tmax;
  if (!__syncthreads_or(live)) {
    if (r < R) {
      t_out[r] = kTmax; tri_out[r] = -1; a_out[r] = 0.f; b_out[r] = 0.f;
    }
    return;
  }
  // min(tmax, best t), NaN-propagating as torch.minimum
  float bound = tmax > kBig ? kBig : tmax;
  float best_a = 0.f, best_b = 0.f;
  int best_tri = -1;

  for (int j0 = 0; j0 < T; j0 += kTile) {
    const int n = min(kTile, T - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int j = j0 + i;
      const float ax = p0[3 * j], ay = p0[3 * j + 1], az = p0[3 * j + 2];
      s_tri[0][i] = ax;
      s_tri[1][i] = ay;
      s_tri[2][i] = az;
      s_tri[3][i] = p1[3 * j] - ax;
      s_tri[4][i] = p1[3 * j + 1] - ay;
      s_tri[5][i] = p1[3 * j + 2] - az;
      s_tri[6][i] = p2[3 * j] - ax;
      s_tri[7][i] = p2[3 * j + 1] - ay;
      s_tri[8][i] = p2[3 * j + 2] - az;
      s_valid[i] = valid[j];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float e0x = s_tri[3][i], e0y = s_tri[4][i], e0z = s_tri[5][i];
      const float e1x = s_tri[6][i], e1y = s_tri[7][i], e1z = s_tri[8][i];
      const float pvx = dy * e1z - dz * e1y;
      const float pvy = dz * e1x - dx * e1z;
      const float pvz = dx * e1y - dy * e1x;
      const float det = e0x * pvx + e0y * pvy + e0z * pvz;
      const float inv_det = 1.0f / det;
      const float tvx = ox - s_tri[0][i];
      const float tvy = oy - s_tri[1][i];
      const float tvz = oz - s_tri[2][i];
      const float a = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e0z - tvz * e0y;
      const float qvy = tvz * e0x - tvx * e0z;
      const float qvz = tvx * e0y - tvy * e0x;
      const float b = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e1x * qvx + e1y * qvy + e1z * qvz) * inv_det;
      if (a >= 0.f && a <= 1.f && b >= 0.f && a + b <= 1.f && det != 0.f &&
          t >= tmin && t < bound && s_valid[i] > 0) {
        bound = t;
        best_tri = j0 + i;
        best_a = a;
        best_b = b;
      }
    }
  }
  if (r < R) {
    const bool got = best_tri >= 0;
    t_out[r] = got ? bound : kTmax;
    tri_out[r] = best_tri;
    a_out[r] = best_a;
    b_out[r] = best_b;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int rt_mt_trace(const float* p0, const float* p1, const float* p2,
                           const int* valid, int T, const float* orig,
                           const float* dir, const float* tmin,
                           const float* tmax, int R, float* t_out,
                           int* tri_out, float* a_out, float* b_out,
                           void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    mt_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p0, p1, p2, valid, T, orig, dir, tmin, tmax, R, t_out, tri_out,
        a_out, b_out);
  }
  return (int)cudaGetLastError();
}
