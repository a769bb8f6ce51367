// The backward of core/vecmath.take on the card for Hopper (sm_90a): the
// rows of a float32 gradient (N, K, C) added into a zeroed table (M, C) at
// the rows that an index (N, K) names, out[idx[n, k], c] += grad[n, k, c].
//
// Replaces no TPU kernel. The JAX package reads `table[idx]` and XLA
// transposes each gather into a scatter-add; the port's gathers are
// index_select, whose autograd backward (index_add) makes one global
// atomicAdd per element. The bounce step's wavefront is sorted into Morton
// order, so neighbouring rays often read the same material row and, at the
// first bounce, the same triangle corners; after it a warp's rays seldom
// share a triangle. Every ray without a hit reads triangle 0 and sends it
// an exactly zero gradient.
//
// What bounds it on the H100: its bytes (each gradient and index element
// read once, each table entry written once; one add per element), so the
// cost to cut is the global atomics and their serialisation on hot
// addresses, not arithmetic. The design:
//  * a block takes a contiguous chunk of rows, in tiles of kThreads rows,
//    one row a thread; for each index column k the lanes of a warp find
//    the heads of their runs of equal indices (a lane whose index differs
//    from the lane before it) and sum each run's channels with a
//    segmented suffix scan of __shfl_down_sync, so a run makes one add;
//  * a run whose sum is exactly zero in every channel adds nothing, and
//    nor does a zero channel: that is exact, an entry starts at +0.0, a
//    sum begun at +0.0 never becomes -0.0, so adding a +-0.0 leaves every
//    entry as it was; a NaN is not zero and still reaches its entry;
//  * mode table_shared (the table fits in 47 KB: the material rows): the
//    heads add into a block-private copy of the whole table with
//    shared-memory atomics, and the block ends with one global add per
//    nonzero (row, channel);
//  * mode table_global (the vertices, the texel pool), C <= 4: the heads
//    add into a block-private open-addressed table in shared memory,
//    kSlots rows keyed by the table row (an int32 claimed with atomicCAS,
//    linear probing, float values added with shared-memory atomics), and
//    the block ends with one global add per row it touched. Once kFill
//    slots are taken (a chunk of the texel pool's 16-112 entries a ray may
//    name more rows than the table holds), a row not yet in the table
//    adds to global memory at once, as does a row that finds kProbes
//    slots taken by others: both as exact, and the probes stay short;
//  * table_global with C > 4: each run adds to global memory, one scalar
//    atomic a channel.
// Sums are taken in another order than index_add's (itself run-to-run
// nondeterministic on the card), so a result agrees with it to float
// rounding of the sums, not bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;           // rows of a tile
constexpr unsigned kFull = 0xFFFFFFFFu;
// table_shared: at most this many blocks, each ending with a flush of the
// whole table, and the table within the 48 KB a block may take without an
// opt-in attribute
constexpr int kMaxBlocksDense = 132 * 2;
constexpr int64_t kDenseBytes = 47 * 1024;
// table_global's block table: kSlots (a power of two) rows of float4
// values and int32 keys, 80 KB, two blocks an SM; a block takes about
// kChunkEntries index entries (rows x K, at least one tile), more than
// kSlots, so that rows met more than once in a chunk fill the table, and
// claims at most kFill slots
constexpr int kSlotBits = 12;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kFill = kSlots / 4 * 3;
constexpr int kProbes = 32;
constexpr int kChunkEntries = 6144;
constexpr size_t kTableBytes = (size_t)kSlots * (sizeof(float4) + 4);
// the block-private table a kernel keeps
enum Store { kDense, kHashed, kDirect };

// the slot of `row` in the block's table, claiming an empty one (key -1)
// while fewer than kFill are taken (`used` counts them); -1 when the row
// is not in the table and may not claim a slot. Nothing leaves the table,
// so a row in it lies before the first empty slot of its probes
__device__ __forceinline__ int slot_of(int *keys, int *used, int row) {
  const unsigned h = ((unsigned)row * 2654435761u) >> (32 - kSlotBits);
  for (int p = 0; p < kProbes; ++p) {
    const int s = (int)((h + p) & (kSlots - 1));
    int k = ((volatile int *)keys)[s];
    if (k == -1) {
      if (*(volatile int *)used >= kFill) return -1;
      k = atomicCAS(keys + s, -1, row);
      if (k == -1) {
        atomicAdd(used, 1);
        return s;
      }
    }
    if (k == row) return s;
  }
  return -1;
}

__device__ __forceinline__ bool all_zero(const float (&v)[4]) {
  return v[0] == 0.0f && v[1] == 0.0f && v[2] == 0.0f && v[3] == 0.0f;
}

// the nonzero sums of channels c0 .. c0 + nc - 1 added at `to`
__device__ __forceinline__ void add_nonzero(float *to, int nc,
                                            const float (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nc && v[j] != 0.0f) atomicAdd(to + j, v[j]);
}

// one run's sums (channels c0 .. c0 + nc - 1, the rest zero), added where
// the kernel's store keeps them
template <int kStore>
__device__ __forceinline__ void add_run(float *dense, float4 *vals,
                                        int *keys, int *used, float *out,
                                        int64_t row, int c0, int nc, int C,
                                        int M, const float (&v)[4]) {
  if (row < 0 || row >= M || all_zero(v)) return;   // a tile's dead tail
  if (kStore == kDense) {
    add_nonzero(dense + row * C + c0, nc, v);
    return;
  }
  if (kStore == kHashed) {
    const int s = slot_of(keys, used, (int)row);
    if (s >= 0) {
      add_nonzero(reinterpret_cast<float *>(vals + s), nc, v);
      return;
    }
  }
  add_nonzero(out + row * C + c0, nc, v);
}

// the row table's kernel at two blocks an SM (64 registers a thread), so
// that one block's reads overlap the other's flush
template <typename Index, int kStore>
__global__ void __launch_bounds__(kThreads, kStore == kHashed ? 2 : 1)
    take_scatter_kernel(
    const float *__restrict__ grad, const Index *__restrict__ idx,
    float *__restrict__ out, int64_t n_rows, int K, int C, int M,
    int64_t rows_per_block) {
  extern __shared__ float4 smem[];
  __shared__ int used;                                      // slots taken
  float *dense = reinterpret_cast<float *>(smem);           // M * C
  float4 *vals = smem;                                      // kSlots
  int *keys = reinterpret_cast<int *>(smem + kSlots);       // kSlots
  if (kStore == kDense) {
    for (int64_t i = threadIdx.x; i < (int64_t)M * C; i += kThreads)
      dense[i] = 0.0f;
  } else if (kStore == kHashed) {
    for (int i = threadIdx.x; i < kSlots; i += kThreads) {
      vals[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      keys[i] = -1;
    }
    if (threadIdx.x == 0) used = 0;
  }
  if (kStore != kDirect) __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t begin = blockIdx.x * rows_per_block;
  const int64_t end = begin + rows_per_block < n_rows
                          ? begin + rows_per_block : n_rows;
  const unsigned upto = (2u << lane) - 1u;   // lanes 0..lane (2u << 31 == 0)
  for (int64_t t0 = begin; t0 < end; t0 += kThreads) {
    const int64_t n = t0 + threadIdx.x;
    const bool valid = n < end;
    for (int k = 0; k < K; ++k) {
      // runs of equal indices among the warp's rows; the rows past the
      // end of the block's chunk form a run of key -1, which adds nothing
      const int64_t key = valid ? (int64_t)idx[n * K + k] : -1;
      const int64_t prev = __shfl_up_sync(kFull, key, 1);
      const bool head = lane == 0 || key != prev;
      const unsigned later = __ballot_sync(kFull, head) & ~upto;
      const int run_end = later ? __ffs(later) - 1 : 32;
      for (int c0 = 0; c0 < C; c0 += 4) {
        const int nc = C - c0 < 4 ? C - c0 : 4;    // the same in every lane
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = valid && j < nc ? grad[(n * K + k) * C + c0 + j] : 0.0f;
        // each lane: the sum from itself to the end of its run
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nc) {
              const float o = __shfl_down_sync(kFull, v[j], d);
              if (lane + d < run_end) v[j] += o;
            }
          }
        }
        if (head)
          add_run<kStore>(dense, vals, keys, &used, out, key, c0, nc, C, M,
                          v);
      }
    }
  }
  if (kStore == kDirect) return;
  __syncthreads();
  if (kStore == kDense) {
    // an entry's sum began at +0.0, so a zero sum adds nothing
    for (int64_t i = threadIdx.x; i < (int64_t)M * C; i += kThreads) {
      const float v = dense[i];
      if (v != 0.0f) atomicAdd(out + i, v);
    }
    return;
  }
  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    const int row = keys[s];
    if (row < 0) continue;
    const float4 t = vals[s];
    const float v[4] = {t.x, t.y, t.z, t.w};
    add_nonzero(out + (int64_t)row * C, C, v);
  }
}

template <typename Index, int kStore>
int launch(const float *grad, const void *idx, float *out, int64_t n, int K,
           int C, int M, cudaStream_t stream) {
  int64_t rows;
  size_t smem = 0;
  if (kStore == kDense) {
    // at most kMaxBlocksDense blocks, each a whole number of tiles
    const int64_t tiles = (n + kThreads - 1) / kThreads;
    const int64_t want = tiles < kMaxBlocksDense ? tiles : kMaxBlocksDense;
    rows = (tiles + want - 1) / want * kThreads;
    smem = (size_t)M * C * sizeof(float);
  } else {
    // a chunk of about kChunkEntries entries, a whole number of tiles
    const int64_t tiles = (kChunkEntries / K + kThreads - 1) / kThreads;
    rows = (tiles > 1 ? tiles : 1) * kThreads;
    if (kStore == kHashed) {
      smem = kTableBytes;
      const cudaError_t err = cudaFuncSetAttribute(
          take_scatter_kernel<Index, kStore>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  const int64_t blocks = (n + rows - 1) / rows;
  take_scatter_kernel<Index, kStore><<<(unsigned)blocks, kThreads, smem,
                                       stream>>>(
      grad, (const Index *)idx, out, n, K, C, M, rows);
  return (int)cudaGetLastError();
}

template <typename Index>
int launch_mode(const float *grad, const void *idx, float *out, int64_t n,
                int K, int C, int M, int shared, cudaStream_t stream) {
  if (shared)
    return launch<Index, kDense>(grad, idx, out, n, K, C, M, stream);
  if (C <= 4)
    return launch<Index, kHashed>(grad, idx, out, n, K, C, M, stream);
  return launch<Index, kDirect>(grad, idx, out, n, K, C, M, stream);
}

}  // namespace

// out (m, c), zeroed by the caller, += grad (n, k, c) at the rows idx (n,
// k) names (int64 if idx64, else int32), on `stream` -> the launch's CUDA
// error code. `shared` takes the table_shared mode, whose table must fit in
// 47 KB of shared memory.
extern "C" int rt_take_scatter(const float *grad, const void *idx, int idx64,
                               float *out, int64_t n, int64_t k, int64_t c,
                               int64_t m, int shared, cudaStream_t stream) {
  if (n == 0) return 0;
  if (n < 0 || k <= 0 || c <= 0 || m <= 0 || n * k >= (1ll << 31) ||
      m * c >= (1ll << 31) ||
      (shared && m * c * (int64_t)sizeof(float) > kDenseBytes))
    return (int)cudaErrorInvalidValue;
  const int K = (int)k, C = (int)c, M = (int)m;
  if (idx64)
    return launch_mode<int64_t>(grad, idx, out, n, K, C, M, shared, stream);
  return launch_mode<int32_t>(grad, idx, out, n, K, C, M, shared, stream);
}
