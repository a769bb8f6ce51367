// Cluster tracer for Hopper (sm_90a): one thread per ray, the 32 rays of a
// warp walking the cluster table together.
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
// matmuls, packed 15-bit picks, VMEM table chunks) is not carried over.
//
// The walk. The wrapper passes three levels of union boxes over table order
// (ops/bundle.group_levels), each of kFan = 8 consecutive members: groups of
// 8, 64 and 512 clusters. The top level is scanned linearly, so any table
// size works. A union box's key is never larger than a member's (float
// rounding is monotone), so skipping a group whose key beats no lane's best
// t drops only clusters the flat scan drops too. The warp walks the levels
// in step: it enters a group if any lane's key beats that lane's best t
// (__any_sync); at a level-1 group every lane keys its 8 clusters at once,
// and the OR over the warp (__reduce_or_sync) lists the clusters to fetch.
// Each fetched cluster's slab (the p0, e1, e2 rows, 3 x 3 x C floats, and
// the C tri ids: 5 KB at C = 128, 9.5 KB with the t = 1 rows of `mb`) is
// copied into one of two per-warp shared-memory buffers by 16-byte
// cp.async copies from all 32 lanes, so the next wanted cluster loads while
// the current one is tested; the next one is chosen with the best t before
// the current test, a superset. A lane then wants the slab only if its own
// key still beats its current best t: exactly the sequential decision. When
// more than kCoopMax lanes want it, each tests its own ray against the
// slab's lanes in order; when fewer, the warp tests one wanting ray at a
// time, each lane taking slab lanes lane, lane + 32, ..., and a shuffle
// reduction keeps the smallest t, the lowest slab lane on a tie: the
// sequential rule, so the results stay bit for bit either way, and a
// cluster that few lanes want no longer idles the rest for 128 tests.
// Dynamic shared memory: 2 buffers x 4 warps x 10 C floats = 40 KB a block
// (static table), 2 x 4 x 19 C floats = 76 KB (`mb`, above the 48 KB
// default, so the launch raises the limit).
//
// No tensor cores: the work is scalar float32 with a divide, and rounding
// as the plain version does excludes wgmma's products.
//
// What bounds it on the H100: the Moller-Trumbore tests, 45 float32
// operations and a divide per (ray, lane) pair, now that the box tests
// fall from M per ray (2,032 for the atrium) to 50-100
// (ops/cluster_trace.TESTS). A warp walks the union of its lanes'
// clusters; the cooperative test makes a cluster few lanes want cost its
// (ray, lane) pairs, not 128 tests of every lane, and a Morton-sorted
// wavefront (render/integrator.py) keeps a warp's rays together. The
// slabs come from the 50 MB L2 (the atrium's table is 10.45 MB) as
// coalesced 16-byte copies that overlap the tests; occupancy is bounded by
// the buffers (5 blocks an SM, 2 with `mb`). At 32,768 rays it runs at
// 74-88x its operations bound (PERF.md section 6), with 256 blocks on 132
// SMs.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using rt::kFullMask;
using rt::kTmax;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the buffers allow 5 blocks an SM (static table): registers up to 102 a
// thread (unbounded, ptxas picked 80 and spilled)
constexpr int kMinBlocks = 5;
constexpr int kFan = 8;     // members per group box, every level
constexpr int kDepth = 3;   // group levels: 8, 64 and 512 clusters
// a staged cluster wanted by at most this many lanes is tested by the whole
// warp, one wanting ray at a time; by more, each lane tests its own ray
constexpr int kCoopMax = 16;

struct Table {
  const float* box[kDepth + 1];   // (6, n[l]): the clusters, then the groups
  int n[kDepth + 1];
  const float* p0;                // (M, 3, C)
  const float* e1;
  const float* e2;
  const float* q0;                // (M, 3, C) t = 1 (MB only)
  const float* q1;
  const float* q2;
  const int* tri;                 // (M, C)
  int C;
};

// floats of one staged slab per lane of the table: the 9 rows of p0, e1 and
// e2 (18 with the t = 1 rows) and the tri ids
template <bool MB>
__host__ __device__ constexpr int slab_rows() { return MB ? 19 : 10; }

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n4 16-byte pieces from src to dst, spread over the warp's lanes
__device__ __forceinline__ void copy_async(float* dst, const void* src,
                                           int n4, int lane) {
  const float* s = static_cast<const float*>(src);
  for (int i = lane; i < n4; i += 32) cp_async16(dst + 4 * i, s + 4 * i);
}

// Cluster c's slab into buf, by all 32 lanes, as one cp.async group
template <bool MB>
__device__ __forceinline__ void stage(float* buf, const Table& T, int c,
                                      int lane) {
  const int row = 3 * T.C;
  const size_t off = (size_t)c * row;
  copy_async(buf, T.p0 + off, row / 4, lane);
  copy_async(buf + row, T.e1 + off, row / 4, lane);
  copy_async(buf + 2 * row, T.e2 + off, row / 4, lane);
  if (MB) {
    copy_async(buf + 3 * row, T.q0 + off, row / 4, lane);
    copy_async(buf + 4 * row, T.q1 + off, row / 4, lane);
    copy_async(buf + 5 * row, T.q2 + off, row / 4, lane);
  }
  copy_async(buf + (MB ? 6 : 3) * row, T.tri + (size_t)c * T.C, T.C / 4,
             lane);
  cp_async_commit();
}

// the tri id of slab lane l in a staged buffer
template <bool MB>
__device__ __forceinline__ int tri_of(const float* buf, int C, int l) {
  return reinterpret_cast<const int*>(buf + (MB ? 18 : 9) * C)[l];
}

// Moller-Trumbore of a ray against slab lane l of a staged buffer, its
// basis lerped to the ray's time w first when MB (the Pallas order:
// p + time * (q - p), per component)
template <bool MB>
__device__ __forceinline__ bool test_lane(const float* buf, int C, int l,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float w, float tmin, float best_t,
                                          float& t, float& a, float& b) {
  const float* P = buf;
  const float* E1 = buf + 3 * C;
  const float* E2 = buf + 6 * C;
  float px = P[l], py = P[C + l], pz = P[2 * C + l];
  float e1x = E1[l], e1y = E1[C + l], e1z = E1[2 * C + l];
  float e2x = E2[l], e2y = E2[C + l], e2z = E2[2 * C + l];
  if (MB) {
    const float* Q0 = buf + 9 * C;
    const float* Q1 = buf + 12 * C;
    const float* Q2 = buf + 15 * C;
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
  return rt::mt_hit(ox, oy, oz, dx, dy, dz, px, py, pz, e1x, e1y, e1z, e2x,
                    e2y, e2z, tmin, best_t, t, a, b);
}

template <bool MB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cluster_trace_kernel(const Table T,
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
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int C = T.C;
  const int slab = slab_rows<MB>() * C;
  float* buf = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * 2 * slab;
  float* nbuf = buf + slab;

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
  const float ix = rt::rcp_clamped(dx), iy = rt::rcp_clamped(dy),
              iz = rt::rcp_clamped(dz);
  const float best_t0 = tmax < kTmax ? tmax : kTmax;
  float best_t = best_t0, best_a = 0.f, best_b = 0.f;
  int best_tri = -1;
  bool done = !live;

  // does this lane's key against box j of level lv beat its best t?
  auto beats = [&](int lv, int j) {
    return !done && rt::slab_key(T.box[lv], T.n[lv], j, ox, oy, oz, ix, iy,
                                 iz, tmin, tmax) < best_t;
  };
  // The warp's walk, in table order: the next cluster that some lane wants,
  // or -1. The state and every branch are uniform across the warp. A level
  // of a single group is entered untested.
  int i3 = 0, i2 = 0, e2 = 0, i1 = 0, e1 = 0, base = 0;
  unsigned pending = 0;   // wanted clusters of the current level-1 group
  auto next = [&]() -> int {
    for (;;) {
      if (pending) {
        const int j = __ffs(pending) - 1;
        pending &= pending - 1;
        return base + j;
      }
      if (i1 < e1) {
        const int g = i1++;
        if (T.n[1] > 1 && !__any_sync(kFullMask, beats(1, g)))
          continue;
        base = g * kFan;
        unsigned want = 0;
#pragma unroll
        for (int j = 0; j < kFan; ++j)
          if (base + j < T.n[0] && beats(0, base + j)) want |= 1u << j;
        pending = __reduce_or_sync(kFullMask, want);
        continue;
      }
      if (i2 < e2) {
        const int g = i2++;
        if (T.n[2] > 1 && !__any_sync(kFullMask, beats(2, g)))
          continue;
        i1 = g * kFan;
        e1 = min(T.n[1], i1 + kFan);
        continue;
      }
      if (i3 < T.n[3] && !__all_sync(kFullMask, done)) {
        const int g = i3++;
        if (T.n[3] > 1 && !__any_sync(kFullMask, beats(3, g)))
          continue;
        i2 = g * kFan;
        e2 = min(T.n[2], i2 + kFan);
        continue;
      }
      return -1;
    }
  };

  int cur = next();
  if (cur >= 0) stage<MB>(buf, T, cur, lane);
  while (cur >= 0) {
    // the warp leaves once every lane is done (`cheap_any`)
    const int nxt = __all_sync(kFullMask, done) ? -1 : next();
    if (nxt >= 0) {
      stage<MB>(nbuf, T, nxt, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned want = __ballot_sync(kFullMask, beats(0, cur));
    if (__popc(want) > kCoopMax) {
      // many lanes want the cluster: each tests its own ray against the
      // slab's lanes in order
      if (want >> lane & 1u) {
        for (int l = 0; l < C; ++l) {
          const int tid = tri_of<MB>(buf, C, l);
          if (tid < 0) break;   // padding lanes trail the real ones
          float t, a, b;
          if (test_lane<MB>(buf, C, l, ox, oy, oz, dx, dy, dz, w, tmin,
                            best_t, t, a, b)) {
            best_tri = tid;
            if (any_hit) { done = true; break; }
            best_t = t;
            best_a = a;
            best_b = b;
          }
        }
      }
    } else {
      // few lanes want it: the warp tests one wanting ray at a time, each
      // lane the slab lanes lane, lane + 32, ... in order, then the
      // smallest t wins, the lowest slab lane on a tie: the sequential
      // rule, so the same hit, t, a and b
      for (unsigned todo = want; todo; todo &= todo - 1) {
        const int j = __ffs(todo) - 1;
        const float rox = __shfl_sync(kFullMask, ox, j);
        const float roy = __shfl_sync(kFullMask, oy, j);
        const float roz = __shfl_sync(kFullMask, oz, j);
        const float rdx = __shfl_sync(kFullMask, dx, j);
        const float rdy = __shfl_sync(kFullMask, dy, j);
        const float rdz = __shfl_sync(kFullMask, dz, j);
        const float rw = __shfl_sync(kFullMask, w, j);
        const float rtmin = __shfl_sync(kFullMask, tmin, j);
        float bt = __shfl_sync(kFullMask, best_t, j), ba = 0.f, bb = 0.f;
        int bl = C;   // the winning slab lane; C for none
        for (int l = lane; l < C; l += 32) {
          if (tri_of<MB>(buf, C, l) < 0) break;
          float t, a, b;
          if (test_lane<MB>(buf, C, l, rox, roy, roz, rdx, rdy, rdz, rw,
                            rtmin, bt, t, a, b)) {
            bt = t; ba = a; bb = b; bl = l;
            if (any_hit) break;
          }
        }
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) {
          const float ot = __shfl_xor_sync(kFullMask, bt, k);
          const int ol = __shfl_xor_sync(kFullMask, bl, k);
          if (ol < C && (bl == C || ot < bt || (ot == bt && ol < bl))) {
            bt = ot;
            bl = ol;
          }
        }
        if (bl < C) {   // every lane agrees on (bt, bl): fetch its a, b
          const float wa = __shfl_sync(kFullMask, ba, bl & 31);
          const float wb = __shfl_sync(kFullMask, bb, bl & 31);
          if (lane == j) {
            best_tri = tri_of<MB>(buf, C, bl);
            if (any_hit) {
              done = true;
            } else {
              best_t = bt;
              best_a = wa;
              best_b = wb;
            }
          }
        }
      }
    }
    __syncwarp();   // every lane is done with buf before it is refilled
    cur = nxt;
    float* s = buf; buf = nbuf; nbuf = s;
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

template <bool MB>
cudaError_t launch(const Table& T, const float* orig, const float* dir,
                   const float* tmin, const float* tmax, const float* time,
                   int R, int any_hit, float* t_out, int* tri_out,
                   float* a_out, float* b_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * 2 * slab_rows<MB>() * T.C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_trace_kernel<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (R + kThreads - 1) / kThreads;
  cluster_trace_kernel<MB><<<blocks, kThreads, smem, stream>>>(
      T, orig, dir, tmin, tmax, time, R, any_hit, t_out, tri_out, a_out,
      b_out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch. box0 is the
// (6, M) cluster boxes, box1-3 the (6, n1-3) group levels; q0-q2 and time
// are read only when mb != 0; a_out and b_out are written when not null
// (need_ab). C must be a multiple of 4 and every table 16-byte aligned
// (the slabs are copied in 16-byte pieces).
extern "C" int rt_cluster_trace(const float* box0, const float* box1,
                                const float* box2, const float* box3, int n1,
                                int n2, int n3, const float* p0,
                                const float* e1, const float* e2,
                                const float* q0, const float* q1,
                                const float* q2, const int* tri, int M, int C,
                                const float* orig, const float* dir,
                                const float* tmin, const float* tmax,
                                const float* time, int R, int any_hit,
                                int mb, float* t_out, int* tri_out,
                                float* a_out, float* b_out, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const Table T{{box0, box1, box2, box3}, {M, n1, n2, n3}, p0, e1, e2, q0,
                q1, q2, tri, C};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(mb ? launch<true>(T, orig, dir, tmin, tmax, time, R, any_hit,
                                 t_out, tri_out, a_out, b_out, s)
                  : launch<false>(T, orig, dir, tmin, tmax, time, R, any_hit,
                                  t_out, tri_out, a_out, b_out, s));
}
