// Flat two-level (segment) tracer for Hopper (sm_90a): one thread per ray,
// the 32 rays of a warp walking the segment table together.
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
// (instance, run of KIN prototype pool rows) entry with a world box, and one
// whose entry key max(near, 0) beats the ray's best t moves the ray into
// its object space (rows summed m0*ox + m1*oy + m2*oz + m3, the direction
// not renormalised, so t is unchanged) and Moller-Trumbore-tests the real
// lanes of the run's rows in order, keeping a hit only with a strictly
// smaller t. Built with -fmad=false, every multiply and add rounds on its
// own as in the plain version, so t, tri, inst, a and b agree bit for bit.
//
// What the TPU design needed and this one does not: the (RB, E) dense cull
// matrix, the rank-matmul picks packed 15 bits per id, and the table slices
// at the SMEM cap (with a bundle cull per slice and a merge by nearest t).
// One pass over the whole table replaces the slices.
//
// The walk, the cluster kernel's with one level more: the wrapper passes
// four levels of union boxes over the segment table, each of kFan = 8
// consecutive members (groups of 8, 64, 512 and 4,096 segments; the
// 200,000 segments of a 100,000-instance grid give a top level of 49
// groups, scanned linearly). The warp enters a group if any lane's key
// beats its best t, and at a level-1 group the OR of the lanes' wants lists
// the segments to visit, in table order. A union box's key is never larger
// than a member's, so the walk drops only segments the flat scan drops.
//
// The rows. The walk's segments, each with the rows of its run that hold
// real lanes (a per-row count of real lanes, from the wrapper: real lanes
// come first, so a row is tested up to its count, and padding rows are
// skipped), make a sequence of (segment, pool row) items. At a segment's
// first item every lane keys the segment against its best t (exactly the
// sequential decision) and moves its own ray into the segment's object
// space, reading the segment's 12 transform floats, the same row for the
// whole warp (a broadcast). A row's slab (its p0, e1, e2 rows and tri ids,
// 10 C floats: 5 KB at C = 128) is read from shared memory by one of two
// routes, chosen by the wrapper:
//   * resident: when the pool's real rows fit in the wrapper's
//     RESIDENT_BYTES (48 KB), the block copies them all into shared memory
//     once, by cp.async (the 100,000-instance grid shares 8 pool rows,
//     40 KB);
//   * staged: otherwise (the final forest without trees: 14 rows, 70 KB)
//     each warp copies the rows it visits into two
//     buffers by 16-byte cp.async copies of all 32 lanes, so the next item's
//     row loads while the current one is tested (the next item is chosen
//     with the best t before the test, a superset); a row that a buffer
//     already holds is not copied again.
// Then, as in the cluster kernel: when more than kCoopMax lanes want the
// row, each tests its own (object-space) ray against the row's lanes in
// order; when fewer, the warp tests one wanting ray at a time, its object
// ray broadcast by shuffles, the lanes splitting the row's lanes, and a
// shuffle reduction keeps the smallest t, the lowest lane on a tie
// (rt::coop_test): the sequential rule, bit for bit.
//
// What bounds it on the H100: the Moller-Trumbore tests (45 float32
// operations and a divide per (ray, lane) pair) and the box tests of the
// walk, which the plain version counts (ops/cluster_trace.TESTS). A warp
// walks the union of its lanes' groups; the cooperative test makes a row
// few lanes want cost its (ray, lane) pairs. No tensor cores: scalar
// float32 with a divide, rounded as the plain version does.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using rt::kFullMask;
using rt::kTmax;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// at least 4 blocks an SM: up to 128 registers a thread
constexpr int kMinBlocks = 4;
constexpr int kDepth = 4;   // group levels: 8, 64, 512 and 4,096 segments
constexpr int kKin = 4;     // pool rows per segment
constexpr int kSlab = 10;   // floats per lane of a staged row

struct Table {
  const float* box[kDepth + 1];   // (6, n[l]): the segments, then the groups
  int n[kDepth + 1];
  const int* smeta;               // (E, 3): [inst row, base pool row, inst]
  const float* strf;              // (E, 12) world -> object rows
  const float* p0;                // (Mtot * 3, C)
  const float* e1;
  const float* e2;
  const int* tri;                 // (Mtot, C)
  const int* lanes;               // (Mtot,) real lanes of each pool row
  const int* slot;                // (Mtot,) its resident slab, or -1
  int rows;                       // Mtot
  int C;
};

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
iseg_trace_kernel(const __grid_constant__ Table T,
                  const float* __restrict__ orig,      // (R, 3)
                  const float* __restrict__ dir,       // (R, 3)
                  const float* __restrict__ tmin_in,   // (R,)
                  const float* __restrict__ tmax_in,   // (R,)
                  int R, int any_hit,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  int* __restrict__ inst_out, float* __restrict__ a_out,
                  float* __restrict__ b_out) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int C = T.C;
  const int slab = kSlab * C;
  // resident: the pool's slabs; staged: two buffers per warp
  float* const pool = reinterpret_cast<float*>(smem);
  float* buf = pool + (threadIdx.x >> 5) * 2 * slab;
  float* nbuf = buf + slab;

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
  const bool live = tmax > 0.f;
  if (!__syncthreads_or(live)) {
    if (r < R) {
      t_out[r] = kTmax; tri_out[r] = -1; inst_out[r] = 0;
      if (a_out) { a_out[r] = 0.f; b_out[r] = 0.f; }
    }
    return;
  }
  if (RESIDENT) {
    for (int row = 0; row < T.rows; ++row) {
      const int s = T.slot[row];
      if (s >= 0)
        rt::stage_slab(pool + s * slab, T.p0, T.e1, T.e2, T.tri, row, C,
                       threadIdx.x, kThreads);
    }
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
  }
  const float ix = rt::rcp_clamped(dx), iy = rt::rcp_clamped(dy),
              iz = rt::rcp_clamped(dz);
  const float best_t0 = tmax < kTmax ? tmax : kTmax;
  float best_t = best_t0, best_a = 0.f, best_b = 0.f;
  int best_tri = -1, best_inst = 0;
  bool done = !live;

  // does this lane's key against box j of level lv beat its best t?
  auto beats = [&](int lv, int j) {
    return !done && rt::slab_key(T.box[lv], T.n[lv], j, ox, oy, oz, ix, iy,
                                 iz, tmin, tmax) < best_t;
  };
  // The warp's walk, in table order: the next segment that some lane wants,
  // or -1. The state and every branch are uniform across the warp. A level
  // of a single group is entered untested.
  int i4 = 0, i3 = 0, e3 = 0, i2 = 0, e2 = 0, i1 = 0, e1 = 0, base = 0;
  unsigned pending = 0;   // wanted segments of the current level-1 group
  auto next = [&]() -> int {
    for (;;) {
      if (pending) {
        const int j = __ffs(pending) - 1;
        pending &= pending - 1;
        return base + j;
      }
      if (i1 < e1) {
        const int g = i1++;
        if (T.n[1] > 1 && !__any_sync(kFullMask, beats(1, g))) continue;
        base = g * rt::kFan;
        unsigned want = 0;
#pragma unroll
        for (int j = 0; j < rt::kFan; ++j)
          if (base + j < T.n[0] && beats(0, base + j)) want |= 1u << j;
        pending = __reduce_or_sync(kFullMask, want);
        continue;
      }
      if (i2 < e2) {
        const int g = i2++;
        if (T.n[2] > 1 && !__any_sync(kFullMask, beats(2, g))) continue;
        i1 = g * rt::kFan;
        e1 = min(T.n[1], i1 + rt::kFan);
        continue;
      }
      if (i3 < e3) {
        const int g = i3++;
        if (T.n[3] > 1 && !__any_sync(kFullMask, beats(3, g))) continue;
        i2 = g * rt::kFan;
        e2 = min(T.n[2], i2 + rt::kFan);
        continue;
      }
      if (i4 < T.n[4] && !__all_sync(kFullMask, done)) {
        const int g = i4++;
        if (T.n[4] > 1 && !__any_sync(kFullMask, beats(4, g))) continue;
        i3 = g * rt::kFan;
        e3 = min(T.n[3], i3 + rt::kFan);
        continue;
      }
      return -1;
    }
  };
  // the item after (segment e, its row k): the next row of e with real
  // lanes, else the walk's next segment's first such row; e = -1 at the
  // end, and once every lane is done (`cheap_any`)
  auto advance = [&](int& e, int& k) {
    for (;;) {
      for (++k; k < kKin; ++k)
        if (T.lanes[T.smeta[3 * e + 1] + k] > 0) return;
      e = __all_sync(kFullMask, done) ? -1 : next();
      if (e < 0) return;
      k = -1;
    }
  };
  auto row_of = [&](int e, int k) {
    return e >= 0 ? T.smeta[3 * e + 1] + k : -1;
  };

  int e = 0, k = kKin - 1;
  advance(e, k);
  int row = row_of(e, k);
  int nheld = -1;   // the row in nbuf (staged route)
  if (!RESIDENT && e >= 0) {
    rt::stage_slab(buf, T.p0, T.e1, T.e2, T.tri, row, C, lane, 32);
    rt::cp_async_commit();
  }
  int seg = -1;        // the segment whose wants and object space are held
  unsigned want = 0;   // the lanes whose key beat their best t at its start
  int inst = 0;
  float lx = 0.f, ly = 0.f, lz = 0.f, ux = 0.f, uy = 0.f, uz = 0.f;
  while (e >= 0) {
    // the next item, chosen with the best t before the current test
    int ne = e, nk = k;
    advance(ne, nk);
    const int nrow = row_of(ne, nk);
    const float* rs;
    if (RESIDENT) {
      rs = pool + T.slot[row] * slab;
    } else {
      if (nrow >= 0 && nrow != row && nrow != nheld) {
        rt::stage_slab(nbuf, T.p0, T.e1, T.e2, T.tri, nrow, C, lane, 32);
        nheld = nrow;
      }
      rt::cp_async_commit();   // a group each step, empty or not
      rt::cp_async_wait<1>();
      __syncwarp();
      rs = buf;
    }
    if (e != seg) {   // a new segment: who wants it, and its object space
      seg = e;
      want = __ballot_sync(kFullMask, beats(0, e));
      const float* m = T.strf + 12 * (size_t)e;
      lx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
      ly = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
      lz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
      ux = m[0] * dx + m[1] * dy + m[2] * dz;
      uy = m[4] * dx + m[5] * dy + m[6] * dz;
      uz = m[8] * dx + m[9] * dy + m[10] * dz;
      inst = T.smeta[3 * e + 2];
    }
    const unsigned act = want & __ballot_sync(kFullMask, !done);
    const int n = T.lanes[row];
    if (__popc(act) > rt::kCoopMax) {
      // many lanes want the row: each tests its own ray against its lanes
      if (act >> lane & 1u) {
        for (int l = 0; l < n; ++l) {
          float t, a, b;
          if (rt::slab_hit(rs, C, l, lx, ly, lz, ux, uy, uz, tmin, best_t, t,
                           a, b)) {
            best_tri = rt::slab_tri(rs, C, l);
            if (any_hit) { done = true; break; }
            best_t = t;
            best_a = a;
            best_b = b;
            best_inst = inst;
          }
        }
      }
    } else {
      // few lanes want it: the warp tests one wanting ray at a time
      for (unsigned todo = act; todo; todo &= todo - 1) {
        const int j = __ffs(todo) - 1;
        const float rox = __shfl_sync(kFullMask, lx, j);
        const float roy = __shfl_sync(kFullMask, ly, j);
        const float roz = __shfl_sync(kFullMask, lz, j);
        const float rdx = __shfl_sync(kFullMask, ux, j);
        const float rdy = __shfl_sync(kFullMask, uy, j);
        const float rdz = __shfl_sync(kFullMask, uz, j);
        const float rtmin = __shfl_sync(kFullMask, tmin, j);
        float bt = __shfl_sync(kFullMask, best_t, j), wa = 0.f, wb = 0.f;
        auto test = [&](int l, float bound, float& t, float& a, float& b) {
          return rt::slab_hit(rs, C, l, rox, roy, roz, rdx, rdy, rdz, rtmin,
                              bound, t, a, b);
        };
        const int bl = rt::coop_test(n, lane, any_hit, test, bt, wa, wb);
        if (bl != rt::kNoLane && lane == j) {
          best_tri = rt::slab_tri(rs, C, bl);
          if (any_hit) {
            done = true;
          } else {
            best_t = bt;
            best_a = wa;
            best_b = wb;
            best_inst = inst;
          }
        }
      }
    }
    if (!RESIDENT && nrow != row) {
      __syncwarp();   // every lane is done with buf before it is refilled
      float* s = buf; buf = nbuf; nbuf = s;
      nheld = row;
    }
    e = ne;
    k = nk;
    row = nrow;
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

template <bool RESIDENT>
cudaError_t launch(const Table& T, int n_slots, const float* orig,
                   const float* dir, const float* tmin, const float* tmax,
                   int R, int any_hit, float* t_out, int* tri_out,
                   int* inst_out, float* a_out, float* b_out,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (RESIDENT ? n_slots : 2 * kWarps) * kSlab * T.C;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        iseg_trace_kernel<RESIDENT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (R + kThreads - 1) / kThreads;
  iseg_trace_kernel<RESIDENT><<<blocks, kThreads, smem, stream>>>(
      T, orig, dir, tmin, tmax, R, any_hit, t_out, tri_out, inst_out, a_out,
      b_out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch. box0 is the
// (6, n0) boxes of the n0 real segments, box1-4 the (6, n1-4) group levels;
// lanes (Mtot,) the real lanes of each pool row; slot (Mtot,) each row's
// slab in the resident pool (-1 for a row without real lanes) when
// n_slots > 0, else the rows are staged per warp; a_out and b_out are
// written when not null (need_ab). C must be a multiple of 4 and the pool
// 16-byte aligned (the slabs are copied in 16-byte pieces).
extern "C" int rt_iseg_trace(const float* box0, const float* box1,
                             const float* box2, const float* box3,
                             const float* box4, int n0, int n1, int n2,
                             int n3, int n4, const int* smeta,
                             const float* strf, const float* p0,
                             const float* e1, const float* e2, const int* tri,
                             const int* lanes, const int* slot, int rows,
                             int n_slots, int C, const float* orig,
                             const float* dir, const float* tmin,
                             const float* tmax, int R, int any_hit,
                             float* t_out, int* tri_out, int* inst_out,
                             float* a_out, float* b_out, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const Table T{{box0, box1, box2, box3, box4}, {n0, n1, n2, n3, n4}, smeta,
                strf, p0, e1, e2, tri, lanes, slot, rows, C};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(n_slots > 0
                   ? launch<true>(T, n_slots, orig, dir, tmin, tmax, R,
                                  any_hit, t_out, tri_out, inst_out, a_out,
                                  b_out, s)
                   : launch<false>(T, 0, orig, dir, tmin, tmax, R, any_hit,
                                   t_out, tri_out, inst_out, a_out, b_out,
                                   s));
}
