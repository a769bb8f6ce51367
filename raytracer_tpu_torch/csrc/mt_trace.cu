// Brute-force Moller-Trumbore sweep for Hopper (sm_90a): kRays rays a
// thread, triangles staged as float4 rows, the triangle range split across
// blocks when the rays alone cannot fill the card.
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
// every sum written in _mt_block's order (rt::mt_hit with e0 = p1 - p0,
// e1 = p2 - p0: inv_det = 1 / det, a = dot(tvec, pvec) * inv_det, each dot
// summed x, y, z), every multiply and add rounds on its own as in the plain
// version. A ray whose interval [tmin, tmax) is empty (a dead ray: tmax <=
// 0 < tmin) never hits, and a block of such rays leaves at once. A miss
// writes t = MIRO_TMAX, tri = -1, a = b = 0; a hit writes the winning
// triangle's own a and b.
//
// Three launches on one stream:
//   1. prep: each triangle as three float4 rows, (p0, valid), (e0, 0),
//      (e1, 0), the edges formed once with the subtraction _mt_block does
//      (48 bytes a triangle); with a split grid, every ray's merge key set
//      to "no hit";
//   2. sweep: a block of kThreads threads holds kThreads * kRays rays in
//      registers and walks its triangle range in tiles of kTile, each
//      copied by cp.async into one of two shared-memory buffers while the
//      other is tested: each triangle's three 16-byte loads, the same
//      address for every thread (a broadcast), feed kRays tests. When the
//      ray blocks are too few to fill the card, the wrapper splits the
//      triangle range across gridDim.y (ops/cuda/mt_kernel.py:splits); each
//      split finds its own best and merges it by an atomicMin on a 64-bit
//      key, (t's order-preserving bits, triangle id), -0 counted as +0, so
//      the smallest key is the smallest t and, at an exact tie, the lowest
//      id: the sequential rule;
//   3. resolve (split grids only): each ray's winner's t, a and b
//      recomputed with the same arithmetic in the same order, so the same
//      bits.
//
// What bounds it on the H100: operations, about 45 float32 multiplies and
// adds (no contraction) and an IEEE divide per (ray, triangle) pair; the
// work is every live ray times every triangle, which is why the JAX
// package keeps this sweep off the main path.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using rt::kTmax;

constexpr int kThreads = 128;
constexpr int kRays = 4;                      // rays per thread
constexpr int kBlockRays = kThreads * kRays;  // ops/cuda/mt_kernel.BLOCK_RAYS
constexpr int kTile = 256;                    // ops/cuda/mt_kernel.TILE
constexpr float kBig = 3.0e38f;   // the Pallas kernel's running-best start
constexpr unsigned long long kNoHit = ~0ull;

// (t, tri) -> a key whose unsigned order is t's, then tri's; -0 as +0
__device__ __forceinline__ unsigned long long hit_key(float t, int tri) {
  const unsigned u = __float_as_uint(t == 0.f ? 0.f : t);
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (unsigned long long)k << 32 | (unsigned)tri;
}

__global__ void mt_prep_kernel(const float* __restrict__ p0,
                               const float* __restrict__ p1,
                               const float* __restrict__ p2,
                               const int* __restrict__ valid, int T,
                               float4* __restrict__ tri4,
                               unsigned long long* __restrict__ keys, int R) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < T) {
    const float ax = p0[3 * j], ay = p0[3 * j + 1], az = p0[3 * j + 2];
    tri4[3 * j] = make_float4(ax, ay, az, __int_as_float(valid[j]));
    tri4[3 * j + 1] = make_float4(p1[3 * j] - ax, p1[3 * j + 1] - ay,
                                  p1[3 * j + 2] - az, 0.f);
    tri4[3 * j + 2] = make_float4(p2[3 * j] - ax, p2[3 * j + 1] - ay,
                                  p2[3 * j + 2] - az, 0.f);
  }
  if (keys && j < R) keys[j] = kNoHit;
}

__global__ void __launch_bounds__(kThreads)
mt_sweep_kernel(const float4* __restrict__ tri4, int T, int per_split,
                const float* __restrict__ orig,     // (R, 3)
                const float* __restrict__ dir,      // (R, 3)
                const float* __restrict__ tmin_in,  // (R,)
                const float* __restrict__ tmax_in,  // (R,)
                int R,
                float* __restrict__ t_out,          // (R,)
                int* __restrict__ tri_out,          // (R,)
                float* __restrict__ a_out,          // (R,)
                float* __restrict__ b_out,          // (R,)
                unsigned long long* __restrict__ keys) {  // (R,) or null
  __shared__ float4 s_tri[2][3 * kTile];   // 2 x 12 KB

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tmin[kRays], bound[kRays], best_a[kRays], best_b[kRays];
  int best_tri[kRays];
  bool any_live = false;
  const int r0 = blockIdx.x * kBlockRays + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int r = r0 + q * kThreads;
    ox[q] = oy[q] = oz[q] = dx[q] = dy[q] = dz[q] = 0.f;
    tmin[q] = 0.f;
    float tmax = -1.f;   // padding rays are dead
    if (r < R) {
      ox[q] = orig[3 * r]; oy[q] = orig[3 * r + 1]; oz[q] = orig[3 * r + 2];
      dx[q] = dir[3 * r]; dy[q] = dir[3 * r + 1]; dz[q] = dir[3 * r + 2];
      tmin[q] = tmin_in[r];
      tmax = tmax_in[r];
    }
    any_live |= tmin[q] < tmax;
    // min(tmax, best t), NaN-propagating as torch.minimum
    bound[q] = tmax > kBig ? kBig : tmax;
    best_a[q] = best_b[q] = 0.f;
    best_tri[q] = -1;
  }
  const bool block_live = __syncthreads_or(any_live);
  const int j_begin = blockIdx.y * per_split;
  const int j_end = block_live ? min(T, j_begin + per_split) : j_begin;

  // tile j0 into buffer b: 3 n float4 pieces over the block's threads
  auto stage = [&](int j0, int b) {
    const int n4 = 3 * min(kTile, j_end - j0);
    for (int i = threadIdx.x; i < n4; i += kThreads)
      rt::cp_async16(reinterpret_cast<float*>(&s_tri[b][i]),
                     tri4 + 3 * (size_t)j0 + i);
    rt::cp_async_commit();
  };
  if (j_begin < j_end) stage(j_begin, 0);
  for (int j0 = j_begin, b = 0; j0 < j_end; j0 += kTile, b ^= 1) {
    if (j0 + kTile < j_end) {
      stage(j0 + kTile, b ^ 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(kTile, j_end - j0);
    if (any_live) {
      for (int i = 0; i < n; ++i) {
        const float4 P = s_tri[b][3 * i];
        const float4 E0 = s_tri[b][3 * i + 1];
        const float4 E1 = s_tri[b][3 * i + 2];
        const bool valid = __float_as_int(P.w) > 0;
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          float t, a, bb;
          if (rt::mt_hit(ox[q], oy[q], oz[q], dx[q], dy[q], dz[q], P.x, P.y,
                         P.z, E0.x, E0.y, E0.z, E1.x, E1.y, E1.z, tmin[q],
                         bound[q], t, a, bb) &&
              valid) {
            bound[q] = t;
            best_tri[q] = j0 + i;
            best_a[q] = a;
            best_b[q] = bb;
          }
        }
      }
    }
    __syncthreads();   // every thread is done with buffer b before reuse
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int r = r0 + q * kThreads;
    if (r >= R) continue;
    if (keys) {
      if (best_tri[q] >= 0) atomicMin(&keys[r], hit_key(bound[q], best_tri[q]));
    } else {
      const bool got = best_tri[q] >= 0;
      t_out[r] = got ? bound[q] : kTmax;
      tri_out[r] = best_tri[q];
      a_out[r] = best_a[q];
      b_out[r] = best_b[q];
    }
  }
}

__global__ void mt_resolve_kernel(const float4* __restrict__ tri4,
                                  const unsigned long long* __restrict__ keys,
                                  const float* __restrict__ orig,
                                  const float* __restrict__ dir,
                                  const float* __restrict__ tmin_in, int R,
                                  float* __restrict__ t_out,
                                  int* __restrict__ tri_out,
                                  float* __restrict__ a_out,
                                  float* __restrict__ b_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const unsigned long long key = keys[r];
  if (key == kNoHit) {
    t_out[r] = kTmax; tri_out[r] = -1; a_out[r] = 0.f; b_out[r] = 0.f;
    return;
  }
  const int j = (int)(key & 0xffffffffu);
  const float4 P = tri4[3 * j], E0 = tri4[3 * j + 1], E1 = tri4[3 * j + 2];
  float t, a, b;
  rt::mt_hit(orig[3 * r], orig[3 * r + 1], orig[3 * r + 2], dir[3 * r],
             dir[3 * r + 1], dir[3 * r + 2], P.x, P.y, P.z, E0.x, E0.y, E0.z,
             E1.x, E1.y, E1.z, tmin_in[r], kBig, t, a, b);
  t_out[r] = t; tri_out[r] = j; a_out[r] = a; b_out[r] = b;
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launches. tri4 is a
// (T, 3) float4 scratch; per_split triangles (a multiple of kTile) a block
// of the grid's y dimension; keys an (R,) 64-bit scratch, read only when
// the grid is split (per_split < T).
extern "C" int rt_mt_trace(const float* p0, const float* p1, const float* p2,
                           const int* valid, int T, const float* orig,
                           const float* dir, const float* tmin,
                           const float* tmax, int R, float* t_out,
                           int* tri_out, float* a_out, float* b_out,
                           float* tri4, unsigned long long* keys,
                           int per_split, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_split = T > per_split ? (T + per_split - 1) / per_split : 1;
  unsigned long long* k = n_split > 1 ? keys : nullptr;
  const int prep = k ? max(T, R) : T;
  float4* t4 = reinterpret_cast<float4*>(tri4);
  if (prep > 0)
    mt_prep_kernel<<<(prep + 255) / 256, 256, 0, s>>>(p0, p1, p2, valid, T,
                                                      t4, k, R);
  const dim3 grid((R + kBlockRays - 1) / kBlockRays, n_split);
  mt_sweep_kernel<<<grid, kThreads, 0, s>>>(t4, T, per_split, orig, dir,
                                            tmin, tmax, R, t_out, tri_out,
                                            a_out, b_out, k);
  if (k)
    mt_resolve_kernel<<<(R + 255) / 256, 256, 0, s>>>(
        t4, k, orig, dir, tmin, R, t_out, tri_out, a_out, b_out);
  return (int)cudaGetLastError();
}
