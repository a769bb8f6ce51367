// Hierarchical two-level tracer for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/icluster_kernel.py
// (pallas_icluster_trace; bodies _kernel and _trace_block) in all its
// modes: nearest hit; the any-hit `cheap_any` mode of shadow rays; and
// `need_ab` of alpha scenes, which writes the winning lane's own
// barycentrics, computed in the instance's object space (the wrapper traces
// the any-hit rays of alpha scenes as nearest ones: the exact any-hit of the
// alpha march). It follows the rule of the plain PyTorch version
// (raytracer_tpu_torch/ops/icluster_trace.py), so the two agree hit for hit:
// each ray walks the instances in table order; one whose world box entry
// key max(near, 0) beats the ray's best t moves the ray into its object
// space (rows summed m0*ox + m1*oy + m2*oz + m3, the direction not
// renormalised, so t is unchanged); the ray then walks that prototype's
// clusters in table order, slab-tests each cluster box with its own clamped
// reciprocal, and Moller-Trumbore-tests the 128 lanes of one whose key
// beats the best t, keeping a hit only with a strictly smaller t. Built
// with -fmad=false, every multiply and add rounds on its own as in the
// plain version, so t, tri, inst, a and b agree bit for bit.
//
// The TPU kernel's block-nearest instance order, its (RB, I) and (RB, MP)
// key matrices, the packed rank picks and the scene-box bundle cull are not
// carried over: a thread's own walk gives the same t and hit or miss (tri
// and inst may differ from the TPU kernel only at exactly equal t).
//
// What bounds it on the H100: every ray slab-tests every instance box
// (I = 201 for forest_standin, cheap) and, for each instance it enters,
// every cluster box of the prototype (96 per tree): deep prototypes make
// the cluster walk and the triangle slabs, read per thread from the shared
// pool in the 50 MB L2 cache, the cost. Threads of a warp in different
// clusters read uncoalesced. A later version would group instances as the
// segment kernel groups segments, for scenes with many deep instances.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTmax = 1e12f;    // MIRO_TMAX
constexpr float kTiny = 1e-20f;   // the Pallas kernel's reciprocal clamp

__device__ __forceinline__ float rcp_clamped(float v) {
  const float x = fabsf(v) < kTiny ? (v < 0.f ? -kTiny : kTiny) : v;
  return 1.0f / x;
}

// Entry key of a ray against the box in column `j` of six rows of stride
// `n` (lo x, y, z, hi x, y, z), or +inf when the slab test fails.
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

__global__ void __launch_bounds__(kThreads)
icluster_trace_kernel(const float* __restrict__ ibb,    // (6, I)
                      const float* __restrict__ iminv,  // (I, 12)
                      const int* __restrict__ imeta,    // (I, 2)
                      const float* __restrict__ pbb,    // (P * 6, MP)
                      const int* __restrict__ pmeta,    // (P, 2)
                      const float* __restrict__ p0,     // (Mtot * 3, C)
                      const float* __restrict__ e1,     // (Mtot * 3, C)
                      const float* __restrict__ e2,     // (Mtot * 3, C)
                      const int* __restrict__ tri,      // (Mtot, C)
                      int I, int n_inst, int MP, int C,
                      const float* __restrict__ orig,   // (R, 3)
                      const float* __restrict__ dir,    // (R, 3)
                      const float* __restrict__ tmin_in,
                      const float* __restrict__ tmax_in,
                      int R, int any_hit,
                      float* __restrict__ t_out, int* __restrict__ tri_out,
                      int* __restrict__ inst_out, float* __restrict__ a_out,
                      float* __restrict__ b_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = -1.f;   // padding threads are dead rays
  if (r < R) {
    ox = orig[3 * r]; oy = orig[3 * r + 1]; oz = orig[3 * r + 2];
    dx = dir[3 * r]; dy = dir[3 * r + 1]; dz = dir[3 * r + 2];
    tmin = tmin_in[r];
    tmax = tmax_in[r];
  }
  // a ray with tmax <= 0 never hits; the block leaves when all its rays
  // are dead
  if (!__syncthreads_or(tmax > 0.f)) {
    if (r < R) {
      t_out[r] = kTmax; tri_out[r] = -1; inst_out[r] = 0;
      if (a_out) { a_out[r] = 0.f; b_out[r] = 0.f; }
    }
    return;
  }
  const float ix = rcp_clamped(dx), iy = rcp_clamped(dy),
              iz = rcp_clamped(dz);
  const float best_t0 = tmax < kTmax ? tmax : kTmax;
  float best_t = best_t0, best_a = 0.f, best_b = 0.f;
  int best_tri = -1, best_inst = 0;
  bool done = !(tmax > 0.f);

  for (int i = 0; i < n_inst && !done; ++i) {
    if (!(slab_key(ibb, I, i, ox, oy, oz, ix, iy, iz, tmin, tmax) < best_t))
      continue;
    const int proto = imeta[2 * i];
    const int off = pmeta[2 * proto], mlen = pmeta[2 * proto + 1];
    const float* m = iminv + 12 * (size_t)i;
    const float lx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
    const float ly = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
    const float lz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
    const float ux = m[0] * dx + m[1] * dy + m[2] * dz;
    const float uy = m[4] * dx + m[5] * dy + m[6] * dz;
    const float uz = m[8] * dx + m[9] * dy + m[10] * dz;
    const float jx = rcp_clamped(ux), jy = rcp_clamped(uy),
                jz = rcp_clamped(uz);
    const float* cbb = pbb + (size_t)6 * proto * MP;
    for (int c = 0; c < mlen && !done; ++c) {
      if (!(slab_key(cbb, MP, c, lx, ly, lz, jx, jy, jz, tmin, tmax) <
            best_t)) continue;
      const size_t row = (size_t)(off + c);
      const float* P = p0 + row * 3 * C;
      const float* E1 = e1 + row * 3 * C;
      const float* E2 = e2 + row * 3 * C;
      const int* T = tri + row * C;
      for (int l = 0; l < C; ++l) {
        const int tid = T[l];
        if (tid < 0) break;   // padding lanes trail the real ones
        const float e1x = E1[l], e1y = E1[C + l], e1z = E1[2 * C + l];
        const float e2x = E2[l], e2y = E2[C + l], e2z = E2[2 * C + l];
        const float pvx = uy * e2z - uz * e2y;
        const float pvy = uz * e2x - ux * e2z;
        const float pvz = ux * e2y - uy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float inv_det = 1.0f / det;
        const float tvx = lx - P[l], tvy = ly - P[C + l],
                    tvz = lz - P[2 * C + l];
        const float a = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float b = (ux * qvx + uy * qvy + uz * qvz) * inv_det;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        if (a >= 0.f && a <= 1.f && b >= 0.f && a + b <= 1.f &&
            det != 0.f && t >= tmin && t < best_t) {
          best_tri = tid;
          if (any_hit) { done = true; break; }
          best_t = t;
          best_a = a;
          best_b = b;
          best_inst = imeta[2 * i + 1];
        }
      }
    }
  }
  if (r < R) {
    const bool got = best_tri >= 0;
    if (any_hit) {
      t_out[r] = got ? best_t0 : kTmax;
      tri_out[r] = got ? 1 : -1;
      inst_out[r] = 0;
    } else {
      t_out[r] = got ? best_t : kTmax;
      tri_out[r] = best_tri;
      inst_out[r] = got ? best_inst : 0;
    }
    if (a_out) { a_out[r] = best_a; b_out[r] = best_b; }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch. a_out
// and b_out are written when not null (need_ab).
extern "C" int rt_icluster_trace(const float* ibb, const float* iminv,
                                 const int* imeta, const float* pbb,
                                 const int* pmeta, const float* p0,
                                 const float* e1, const float* e2,
                                 const int* tri, int I, int n_inst, int MP,
                                 int C, const float* orig, const float* dir,
                                 const float* tmin, const float* tmax, int R,
                                 int any_hit, float* t_out, int* tri_out,
                                 int* inst_out, float* a_out, float* b_out,
                                 void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    icluster_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ibb, iminv, imeta, pbb, pmeta, p0, e1, e2, tri, I, n_inst, MP, C,
        orig, dir, tmin, tmax, R, any_hit, t_out, tri_out, inst_out, a_out,
        b_out);
  }
  return (int)cudaGetLastError();
}
