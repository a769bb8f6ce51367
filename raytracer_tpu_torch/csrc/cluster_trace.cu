// Cluster tracer for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/cluster_kernel.py
// (pallas_cluster_trace, bodies _kernel and _trace_block) in all its modes:
// nearest hit; the any-hit `cheap_any` mode of shadow rays; `need_ab`, which
// writes the winning lane's own barycentrics a and b (alpha scenes, whose
// any-hit rays the wrapper traces as nearest ones: the exact any-hit of the
// alpha march); and `mb`, which lerps the stored basis per component by the
// ray's time, p + time * (q - p) with q the t = 1 table, before the
// Moller-Trumbore test (cluster_kernel.py:179-187). The cluster boxes bound
// both poses (the native build unions them), so the cull is unchanged. It
// follows the visiting rule of the plain PyTorch version
// (raytracer_tpu_torch/ops/cluster_trace.py), so the two agree hit for hit:
// each ray walks the clusters in table order, Moller-Trumbore-tests the 128
// lanes of a cluster whose box entry key max(near, 0) beats its best t, and
// keeps a hit only with a strictly smaller t. Built with -fmad=false, every
// multiply and add rounds on its own as in the plain version, so t, tri, a
// and b agree bit for bit. The TPU block structure (dense (RB, M) cull, rank
// matmuls, packed 15-bit picks, VMEM table chunks) is not carried over. The
// static kernel (MB = false) reads no t = 1 table.
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

template <bool MB>
__global__ void __launch_bounds__(kThreads)
cluster_trace_kernel(const float* __restrict__ bb_min,   // (M, 3)
                     const float* __restrict__ bb_max,   // (M, 3)
                     const float* __restrict__ p0,       // (M, 3, C)
                     const float* __restrict__ e1,       // (M, 3, C)
                     const float* __restrict__ e2,       // (M, 3, C)
                     const float* __restrict__ q0,       // (M, 3, C) t = 1
                     const float* __restrict__ q1,       //   (MB only)
                     const float* __restrict__ q2,
                     const int* __restrict__ tri,        // (M, C)
                     int M, int C,
                     const float* __restrict__ orig,     // (R, 3)
                     const float* __restrict__ dir,      // (R, 3)
                     const float* __restrict__ tmin_in,  // (R,)
                     const float* __restrict__ tmax_in,  // (R,)
                     const float* __restrict__ time_in,  // (R,), MB only
                     int R, int any_hit,
                     float* __restrict__ t_out,          // (R,)
                     int* __restrict__ tri_out,          // (R,)
                     float* __restrict__ a_out,          // (R,) or null
                     float* __restrict__ b_out) {        // (R,) or null
  __shared__ float s_lo[3][kChunk];
  __shared__ float s_hi[3][kChunk];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = -1.f;   // padding threads are dead rays
  float w = 0.f;                   // ray time (motion blur)
  if (r < R) {
    ox = orig[3 * r]; oy = orig[3 * r + 1]; oz = orig[3 * r + 2];
    dx = dir[3 * r]; dy = dir[3 * r + 1]; dz = dir[3 * r + 2];
    tmin = tmin_in[r];
    tmax = tmax_in[r];
    if (MB) w = time_in[r];
  }
  // a ray with tmax <= 0 can never hit: its best t starts at or below every
  // entry key. The whole block leaves when all its rays are so.
  const bool live = tmax > 0.f;
  if (!__syncthreads_or(live)) {
    if (r < R) {
      t_out[r] = kTmax; tri_out[r] = -1;
      if (a_out) { a_out[r] = 0.f; b_out[r] = 0.f; }
    }
    return;
  }
  const float ix = rcp_clamped(dx), iy = rcp_clamped(dy),
              iz = rcp_clamped(dz);
  const float best_t0 = tmax < kTmax ? tmax : kTmax;
  float best_t = best_t0, best_a = 0.f, best_b = 0.f;
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
        float px = P[l], py = P[C + l], pz = P[2 * C + l];
        float e1x = E1[l], e1y = E1[C + l], e1z = E1[2 * C + l];
        float e2x = E2[l], e2y = E2[C + l], e2z = E2[2 * C + l];
        if (MB) {   // the Pallas order: p + time * (q - p), per component
          const float* Q0 = q0 + base;
          const float* Q1 = q1 + base;
          const float* Q2 = q2 + base;
          px = px + w * (Q0[l] - px);
          py = py + w * (Q0[C + l] - py);
          pz = pz + w * (Q0[2 * C + l] - pz);
          e1x = e1x + w * (Q1[l] - e1x);
          e1y = e1y + w * (Q1[C + l] - e1y);
          e1z = e1z + w * (Q1[2 * C + l] - e1z);
          e2x = e2x + w * (Q2[l] - e2x);
          e2y = e2y + w * (Q2[C + l] - e2y);
          e2z = e2z + w * (Q2[2 * C + l] - e2z);
        }
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float inv_det = 1.0f / det;
        const float tvx = ox - px, tvy = oy - py, tvz = oz - pz;
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
          best_a = a;
          best_b = b;
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
    if (a_out) { a_out[r] = best_a; b_out[r] = best_b; }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch. q0-q2
// and time are read only when mb != 0; a_out and b_out are written when not
// null (need_ab).
extern "C" int rt_cluster_trace(const float* bb_min, const float* bb_max,
                                const float* p0, const float* e1,
                                const float* e2, const float* q0,
                                const float* q1, const float* q2,
                                const int* tri, int M, int C,
                                const float* orig, const float* dir,
                                const float* tmin, const float* tmax,
                                const float* time, int R, int any_hit,
                                int mb, float* t_out, int* tri_out,
                                float* a_out, float* b_out, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    if (mb)
      cluster_trace_kernel<true><<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
          bb_min, bb_max, p0, e1, e2, q0, q1, q2, tri, M, C, orig, dir, tmin,
          tmax, time, R, any_hit, t_out, tri_out, a_out, b_out);
    else
      cluster_trace_kernel<false><<<blocks, kThreads, 0,
                                    (cudaStream_t)stream>>>(
          bb_min, bb_max, p0, e1, e2, q0, q1, q2, tri, M, C, orig, dir, tmin,
          tmax, time, R, any_hit, t_out, tri_out, a_out, b_out);
  }
  return (int)cudaGetLastError();
}
