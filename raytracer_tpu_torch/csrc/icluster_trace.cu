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
// Both walks skip groups. The wrapper passes union boxes over table order
// (ops/bundle.group_levels), each of kFan = 8 consecutive members: three
// levels over the instance boxes (8, 64 and 512 instances), and two over
// each prototype's cluster boxes (8 and 64 clusters, in object space, keyed
// with the object-space reciprocals). The top level of each is scanned
// linearly. A union box's key is never larger than a member's (float
// rounding is monotone), so a group whose key does not beat the best t
// holds no member the flat scan would visit, and the visiting order is
// unchanged. Instances stay in table order: the final forest's 1,600 grass
// clumps are already laid out in grid order, and a Morton order would save
// few box tests (191-274 per camera ray in table order, 190-245 in Morton
// order, against 1,905 flat).
//
// What bounds it on the H100: with the box tests cut, the Moller-Trumbore
// tests of the clusters a ray enters, and their slabs, read per thread from
// the shared pool in the 50 MB L2 cache. Rays of one warp sit in different
// instances, so the reads are uncoalesced, and a shared slab, as the
// cluster kernel stages it, would serve few lanes; it is not staged here.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using rt::kTmax;

constexpr int kThreads = 128;
// at least 4 blocks an SM: up to 128 registers a thread (the walk's state
// spilled at the 64 that ptxas picked unbounded)
constexpr int kMinBlocks = 4;
using rt::kFan;   // members per group box, every level

// A box table and its group levels: level 0 holds the members, level l > 0
// the unions of kFan consecutive boxes of level l - 1. Level l is a (6,
// stride[l]) column table, of which the first count[l] columns are walked.
template <int D>
struct Levels {
  const float* bb[D + 1];
  int stride[D + 1];
  int count[D + 1];
};

// A ray (in world or object space) for the slab tests.
struct SlabRay {
  float ox, oy, oz, ix, iy, iz, tmin, tmax;
};

// A thread's walk over columns [begin, end) of level L, in table order:
// visit(m) for each member whose key beats best_t at its turn; a group
// whose key does not is skipped whole, and a level of a single group is
// entered untested (its box adds nothing to the one above). Stops once
// `done`.
template <int L, int D, typename Visit>
__device__ __forceinline__ void walk(const Levels<D>& T, int begin, int end,
                                     const SlabRay& r, const float& best_t,
                                     const bool& done, Visit& visit) {
  for (int g = begin; g < end && !done; ++g) {
    if ((L == 0 || T.count[L] > 1) &&
        !(rt::slab_key(T.bb[L], T.stride[L], g, r.ox, r.oy, r.oz, r.ix, r.iy,
                       r.iz, r.tmin, r.tmax) < best_t))
      continue;
    if constexpr (L == 0) {
      visit(g);
    } else {
      walk<L - 1>(T, g * kFan, min(T.count[L - 1], (g + 1) * kFan), r,
                  best_t, done, visit);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
icluster_trace_kernel(const Levels<3> inst,           // instance boxes
                      const float* __restrict__ iminv,  // (I, 12)
                      const int* __restrict__ imeta,    // (I, 2)
                      const float* __restrict__ pbb,    // (P * 6, MP)
                      const float* __restrict__ pbb1,   // (P * 6, W1)
                      const float* __restrict__ pbb2,   // (P * 6, W2)
                      const int* __restrict__ pmeta,    // (P, 2)
                      const float* __restrict__ p0,     // (Mtot * 3, C)
                      const float* __restrict__ e1,     // (Mtot * 3, C)
                      const float* __restrict__ e2,     // (Mtot * 3, C)
                      const int* __restrict__ tri,      // (Mtot, C)
                      int MP, int W1, int W2, int C,
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
  const SlabRay world{ox, oy, oz, rt::rcp_clamped(dx), rt::rcp_clamped(dy),
                      rt::rcp_clamped(dz), tmin, tmax};
  const float best_t0 = tmax < kTmax ? tmax : kTmax;
  float best_t = best_t0, best_a = 0.f, best_b = 0.f;
  int best_tri = -1, best_inst = 0;
  bool done = !(tmax > 0.f);

  auto visit_instance = [&](int i) {
    const int proto = imeta[2 * i];
    const int off = pmeta[2 * proto], mlen = pmeta[2 * proto + 1];
    const float* m = iminv + 12 * (size_t)i;
    const float lx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
    const float ly = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
    const float lz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
    const float ux = m[0] * dx + m[1] * dy + m[2] * dz;
    const float uy = m[4] * dx + m[5] * dy + m[6] * dz;
    const float uz = m[8] * dx + m[9] * dy + m[10] * dz;
    const SlabRay local{lx, ly, lz, rt::rcp_clamped(ux), rt::rcp_clamped(uy),
                        rt::rcp_clamped(uz), tmin, tmax};
    const size_t rows = (size_t)6 * proto;
    const Levels<2> clusters{
        {pbb + rows * MP, pbb1 + rows * W1, pbb2 + rows * W2},
        {MP, W1, W2},
        {mlen, (mlen + kFan - 1) / kFan,
         (mlen + kFan * kFan - 1) / (kFan * kFan)}};
    auto visit_cluster = [&](int c) {
      const size_t row = (size_t)(off + c);
      const float* P = p0 + row * 3 * C;
      const float* E1 = e1 + row * 3 * C;
      const float* E2 = e2 + row * 3 * C;
      const int* T = tri + row * C;
      for (int l = 0; l < C; ++l) {
        const int tid = T[l];
        if (tid < 0) break;   // padding lanes trail the real ones
        float t, a, b;
        if (rt::mt_hit(lx, ly, lz, ux, uy, uz, P[l], P[C + l], P[2 * C + l],
                       E1[l], E1[C + l], E1[2 * C + l], E2[l], E2[C + l],
                       E2[2 * C + l], tmin, best_t, t, a, b)) {
          best_tri = tid;
          if (any_hit) { done = true; break; }
          best_t = t;
          best_a = a;
          best_b = b;
          best_inst = imeta[2 * i + 1];
        }
      }
    };
    walk<2>(clusters, 0, clusters.count[2], local, best_t, done,
            visit_cluster);
  };
  walk<3>(inst, 0, inst.count[3], world, best_t, done, visit_instance);

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

// Launches on `stream`; returns cudaGetLastError() after the launch. ibb0
// is the (6, I) instance boxes and ibb1-3 their (6, n1-3) group levels, of
// which the first n_inst, n1, n2, n3 columns are walked; pbb1 and pbb2 are
// the prototypes' (P * 6, W1) and (P * 6, W2) cluster group levels. a_out
// and b_out are written when not null (need_ab).
extern "C" int rt_icluster_trace(const float* ibb0, const float* ibb1,
                                 const float* ibb2, const float* ibb3, int I,
                                 int n_inst, int n1, int n2, int n3,
                                 const float* iminv, const int* imeta,
                                 const float* pbb, const float* pbb1,
                                 const float* pbb2, const int* pmeta,
                                 const float* p0, const float* e1,
                                 const float* e2, const int* tri, int MP,
                                 int W1, int W2, int C, const float* orig,
                                 const float* dir, const float* tmin,
                                 const float* tmax, int R, int any_hit,
                                 float* t_out, int* tri_out, int* inst_out,
                                 float* a_out, float* b_out, void* stream) {
  if (R > 0) {
    const Levels<3> inst{{ibb0, ibb1, ibb2, ibb3},
                         {I, n1, n2, n3},
                         {n_inst, n1, n2, n3}};
    const int blocks = (R + kThreads - 1) / kThreads;
    icluster_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        inst, iminv, imeta, pbb, pbb1, pbb2, pmeta, p0, e1, e2, tri, MP, W1,
        W2, C, orig, dir, tmin, tmax, R, any_hit, t_out, tri_out, inst_out,
        a_out, b_out);
  }
  return (int)cudaGetLastError();
}
