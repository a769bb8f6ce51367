// Flat two-level (segment) tracer for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/iseg_kernel.py
// (pallas_iseg_trace; bodies _kernel, _trace_block and the per-slice
// run_slice) in all its modes: nearest hit; the any-hit `cheap_any` mode of
// shadow rays; and `need_ab` of alpha scenes, which writes the winning
// lane's own barycentrics, computed in the instance's object space (the
// wrapper traces the any-hit rays of alpha scenes as nearest ones: the exact
// any-hit of the alpha march). It follows the rule of the plain PyTorch
// version (raytracer_tpu_torch/ops/iseg_trace.py), so the two agree hit for
// hit: each ray walks the segment table in order; a segment is one
// (instance, run of KIN prototype clusters) entry with a world box, and one
// whose entry key max(near, 0) beats the ray's best t moves the ray into
// its object space (rows summed m0*ox + m1*oy + m2*oz + m3, the direction
// not renormalised, so t is unchanged) and Moller-Trumbore-tests the run's
// lanes, keeping a hit only with a strictly smaller t. Built with
// -fmad=false, every multiply and add rounds on its own as in the plain
// version, so t, tri, inst, a and b agree bit for bit.
//
// What the TPU design needed and this one does not: the (RB, E) dense cull
// matrix, the rank-matmul picks packed 15 bits per id, and the table slices
// at the SMEM cap (with a bundle cull per slice and a merge by nearest t).
// One pass over the whole table replaces the slices.
//
// What bounds it on the H100: at 100,000 instances the table holds about
// 200,000 segments, and a flat scan would slab-test all of them for every
// ray. The wrapper therefore passes two levels of group boxes, unions of 32
// consecutive segments (L1) and of 32 consecutive L1 groups (L2); a ray
// skips a group whose box key does not beat its best t (a level of a
// single group is entered untested). The plain version walks the same
// groups, so its test counts are the kernel's work. A union box's key is
// never larger than a member's (float rounding is monotone), so the skip
// drops only segments the flat scan would drop too, and the visiting order
// is unchanged. Segments are laid out in instance order, which for a grid of
// instances keeps a group's members close together. The triangle slabs are
// read per thread from the shared prototype pool, which stays in the 50 MB
// L2 cache; threads of a warp in different segments read uncoalesced.
// Staging them in shared memory, as the cluster kernel does, is still to
// do.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using rt::kTmax;
using rt::slab_key;

constexpr int kThreads = 128;
constexpr int kGroup = 32;        // segments per L1 group, L1 groups per L2
constexpr int kKin = 4;           // prototype clusters per segment

__global__ void __launch_bounds__(kThreads)
iseg_trace_kernel(const float* __restrict__ sbb,    // (6, E) segment boxes
                  const int* __restrict__ smeta,    // (E, 3)
                  const float* __restrict__ strf,   // (E, 12)
                  const float* __restrict__ g1bb,   // (6, G1) L1 group boxes
                  const float* __restrict__ g2bb,   // (6, G2) L2 group boxes
                  const float* __restrict__ p0,     // (Mtot * 3, C)
                  const float* __restrict__ e1,     // (Mtot * 3, C)
                  const float* __restrict__ e2,     // (Mtot * 3, C)
                  const int* __restrict__ tri,      // (Mtot, C)
                  int E, int n_seg, int G1, int G2, int C,
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
  const float ix = rt::rcp_clamped(dx), iy = rt::rcp_clamped(dy),
              iz = rt::rcp_clamped(dz);
  const float best_t0 = tmax < kTmax ? tmax : kTmax;
  float best_t = best_t0, best_a = 0.f, best_b = 0.f;
  int best_tri = -1, best_inst = 0;
  bool done = !(tmax > 0.f);

  for (int g2 = 0; g2 < G2 && !done; ++g2) {
    if (G2 > 1 && !(slab_key(g2bb, G2, g2, ox, oy, oz, ix, iy, iz, tmin,
                             tmax) < best_t)) continue;
    const int g1_end = min(G1, (g2 + 1) * kGroup);
    for (int g1 = g2 * kGroup; g1 < g1_end && !done; ++g1) {
      if (G1 > 1 && !(slab_key(g1bb, G1, g1, ox, oy, oz, ix, iy, iz, tmin,
                               tmax) < best_t)) continue;
      const int e_end = min(n_seg, (g1 + 1) * kGroup);
      for (int e = g1 * kGroup; e < e_end && !done; ++e) {
        if (!(slab_key(sbb, E, e, ox, oy, oz, ix, iy, iz, tmin, tmax) <
              best_t)) continue;
        const float* m = strf + 12 * (size_t)e;
        const float lx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
        const float ly = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
        const float lz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
        const float ux = m[0] * dx + m[1] * dy + m[2] * dz;
        const float uy = m[4] * dx + m[5] * dy + m[6] * dz;
        const float uz = m[8] * dx + m[9] * dy + m[10] * dz;
        const int base = smeta[3 * e + 1];
        for (int k = 0; k < kKin && !done; ++k) {
          const size_t row = (size_t)(base + k);
          const float* P = p0 + row * 3 * C;
          const float* E1 = e1 + row * 3 * C;
          const float* E2 = e2 + row * 3 * C;
          const int* T = tri + row * C;
          for (int l = 0; l < C; ++l) {
            const int tid = T[l];
            if (tid < 0) break;   // padding lanes trail the real ones
            float t, a, b;
            if (rt::mt_hit(lx, ly, lz, ux, uy, uz, P[l], P[C + l],
                           P[2 * C + l], E1[l], E1[C + l], E1[2 * C + l],
                           E2[l], E2[C + l], E2[2 * C + l], tmin, best_t, t,
                           a, b)) {
              best_tri = tid;
              if (any_hit) { done = true; break; }
              best_t = t;
              best_a = a;
              best_b = b;
              best_inst = smeta[3 * e + 2];
            }
          }
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
extern "C" int rt_iseg_trace(const float* sbb, const int* smeta,
                             const float* strf, const float* g1bb,
                             const float* g2bb, const float* p0,
                             const float* e1, const float* e2, const int* tri,
                             int E, int n_seg, int G1, int G2, int C,
                             const float* orig, const float* dir,
                             const float* tmin, const float* tmax, int R,
                             int any_hit, float* t_out, int* tri_out,
                             int* inst_out, float* a_out, float* b_out,
                             void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    iseg_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        sbb, smeta, strf, g1bb, g2bb, p0, e1, e2, tri, E, n_seg, G1, G2, C,
        orig, dir, tmin, tmax, R, any_hit, t_out, tri_out, inst_out, a_out,
        b_out);
  }
  return (int)cudaGetLastError();
}
