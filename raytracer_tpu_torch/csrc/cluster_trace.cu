// Cluster tracer for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/cluster_kernel.py
// (pallas_cluster_trace, bodies _kernel and _trace_block) in its two static
// modes: nearest hit, and the any-hit `cheap_any` mode of shadow rays. It
// follows the visiting rule of the plain PyTorch version
// (raytracer_tpu_torch/ops/cluster_trace.py), so the two agree hit for hit:
// each ray walks the clusters in table order, Moller-Trumbore-tests the 128
// lanes of a cluster whose box entry key max(near, 0) beats its best t, and
// keeps a hit only with a strictly smaller t. Built with -fmad=false, every
// multiply and add rounds on its own as in the plain version, so t and tri
// agree bit for bit. The TPU block structure (dense (RB, M) cull, rank
// matmuls, packed 15-bit picks, VMEM table chunks) is not carried over.
//
// What bounds it on the H100: each ray slab-tests all M cluster boxes
// (O(M) work per ray, the boxes staged in shared memory kChunk at a time),
// and the triangle slabs are read per thread from the table in device
// memory; that table (10.45 MB for the 174,724-triangle atrium) stays in the
// 50 MB L2, but threads of one warp that visit different clusters make those
// reads uncoalesced. A later version would trace warp-coherent ray blocks
// that share one cluster list across the warp, and put a BVH over the
// cluster boxes in place of the linear scan.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;      // cluster boxes staged per pass (24 KB)
constexpr float kTmax = 1e12f;    // MIRO_TMAX
constexpr float kTiny = 1e-20f;   // the Pallas kernel's reciprocal clamp

__device__ __forceinline__ float rcp_clamped(float v) {
  const float x = fabsf(v) < kTiny ? (v < 0.f ? -kTiny : kTiny) : v;
  return 1.0f / x;
}

__global__ void __launch_bounds__(kThreads)
cluster_trace_kernel(const float* __restrict__ bb_min,   // (M, 3)
                     const float* __restrict__ bb_max,   // (M, 3)
                     const float* __restrict__ p0,       // (M, 3, C)
                     const float* __restrict__ e1,       // (M, 3, C)
                     const float* __restrict__ e2,       // (M, 3, C)
                     const int* __restrict__ tri,        // (M, C)
                     int M, int C,
                     const float* __restrict__ orig,     // (R, 3)
                     const float* __restrict__ dir,      // (R, 3)
                     const float* __restrict__ tmin_in,  // (R,)
                     const float* __restrict__ tmax_in,  // (R,)
                     int R, int any_hit,
                     float* __restrict__ t_out,          // (R,)
                     int* __restrict__ tri_out) {        // (R,)
  __shared__ float s_lo[3][kChunk];
  __shared__ float s_hi[3][kChunk];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = -1.f;   // padding threads are dead rays
  if (r < R) {
    ox = orig[3 * r]; oy = orig[3 * r + 1]; oz = orig[3 * r + 2];
    dx = dir[3 * r]; dy = dir[3 * r + 1]; dz = dir[3 * r + 2];
    tmin = tmin_in[r];
    tmax = tmax_in[r];
  }
  // a ray with tmax <= 0 can never hit: its best t starts at or below every
  // entry key. The whole block leaves when all its rays are so.
  const bool live = tmax > 0.f;
  if (!__syncthreads_or(live)) {
    if (r < R) { t_out[r] = kTmax; tri_out[r] = -1; }
    return;
  }
  const float ix = rcp_clamped(dx), iy = rcp_clamped(dy),
              iz = rcp_clamped(dz);
  const float best_t0 = tmax < kTmax ? tmax : kTmax;
  float best_t = best_t0;
  int best_tri = -1;
  bool done = !live;

  for (int c0 = 0; c0 < M; c0 += kChunk) {
    const int n = min(kChunk, M - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = c0 + i;
      s_lo[0][i] = bb_min[3 * c]; s_lo[1][i] = bb_min[3 * c + 1];
      s_lo[2][i] = bb_min[3 * c + 2];
      s_hi[0][i] = bb_max[3 * c]; s_hi[1][i] = bb_max[3 * c + 1];
      s_hi[2][i] = bb_max[3 * c + 2];
    }
    __syncthreads();
    if (done) continue;
    for (int i = 0; i < n; ++i) {
      const float tx0 = (s_lo[0][i] - ox) * ix, tx1 = (s_hi[0][i] - ox) * ix;
      const float ty0 = (s_lo[1][i] - oy) * iy, ty1 = (s_hi[1][i] - oy) * iy;
      const float tz0 = (s_lo[2][i] - oz) * iz, tz1 = (s_hi[2][i] - oz) * iz;
      const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fminf(tz0, tz1));
      const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                              fmaxf(tz0, tz1));
      if (!(tnear <= tfar && tfar >= tmin && tnear <= tmax)) continue;
      if (!(fmaxf(tnear, 0.f) < best_t)) continue;

      const size_t base = (size_t)(c0 + i) * 3 * C;
      const float* P = p0 + base;
      const float* E1 = e1 + base;
      const float* E2 = e2 + base;
      const int* T = tri + (size_t)(c0 + i) * C;
      for (int l = 0; l < C; ++l) {
        const int tid = T[l];
        if (tid < 0) break;   // padding lanes trail the real ones
        const float e1x = E1[l], e1y = E1[C + l], e1z = E1[2 * C + l];
        const float e2x = E2[l], e2y = E2[C + l], e2z = E2[2 * C + l];
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float inv_det = 1.0f / det;
        const float tvx = ox - P[l], tvy = oy - P[C + l],
                    tvz = oz - P[2 * C + l];
        const float a = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float b = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        if (a >= 0.f && a <= 1.f && b >= 0.f && a + b <= 1.f &&
            det != 0.f && t >= tmin && t < best_t) {
          best_tri = tid;
          if (any_hit) { done = true; break; }
          best_t = t;
        }
      }
      if (done) break;
    }
  }
  if (r < R) {
    const bool got = best_tri >= 0;
    if (any_hit) {
      t_out[r] = got ? best_t0 : kTmax;
      tri_out[r] = got ? 1 : -1;
    } else {
      t_out[r] = got ? best_t : kTmax;
      tri_out[r] = best_tri;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int rt_cluster_trace(const float* bb_min, const float* bb_max,
                                const float* p0, const float* e1,
                                const float* e2, const int* tri, int M, int C,
                                const float* orig, const float* dir,
                                const float* tmin, const float* tmax, int R,
                                int any_hit, float* t_out, int* tri_out,
                                void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    cluster_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        bb_min, bb_max, p0, e1, e2, tri, M, C, orig, dir, tmin, tmax, R,
        any_hit, t_out, tri_out);
  }
  return (int)cudaGetLastError();
}
