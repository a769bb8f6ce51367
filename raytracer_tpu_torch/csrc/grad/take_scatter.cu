// The backward of core/vecmath.take on the card for Hopper (sm_90a): the
// rows of a float32 gradient (N, K, C) added into a zeroed table (M, C) at
// the rows that an index (N, K) names, out[idx[n, k], c] += grad[n, k, c].
//
// Replaces no TPU kernel. The JAX package reads `table[idx]` and XLA
// transposes each gather into a scatter-add; the port's gathers are
// index_select, whose autograd backward (index_add) makes one global
// atomicAdd per element. The bounce step's wavefront is sorted into Morton
// order, so neighbouring rays mostly read the same triangle corners and the
// same material row: those atomics pile onto a few addresses and serialise.
//
// What bounds it on the H100: its bytes (each gradient and index element
// read once, each table entry written once; one add per element), so the
// cost to cut is the serialised atomics, not arithmetic. The design:
//  * a block takes a contiguous run of rows, in tiles of kThreads rows, one
//    row a thread; each warp holds 32 neighbouring rows, and for each index
//    column k the lanes find the heads of their runs of equal indices (a
//    lane whose index differs from the lane before it) and sum each run
//    with a segmented suffix scan of __shfl_down_sync;
//  * a warp's first and last runs may continue in the warps beside it:
//    they go through shared memory, where one thread a channel walks the
//    block's warps in order and joins the runs that carry over;
//  * so each run of a tile makes one add a channel, by its head, and the
//    global atomics fall by the mean run length;
//  * where the table fits in shared memory (the material tables, mode
//    table_shared) those adds go to a block-private copy with shared-memory
//    atomics, and the block ends with one global add per nonzero (row,
//    channel); else (the vertices, the texel pool: table_global) they are
//    global atomics.
// Sums are taken in another order than index_add's (itself run-to-run
// nondeterministic on the card), so a result agrees with it to float
// rounding of the sums, not bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;     // rows of a tile
constexpr int kMaxBlocksGlobal = 132 * 8;
// fewer blocks where each ends with a flush of the whole table
constexpr int kMaxBlocksShared = 132 * 2;
constexpr unsigned kFull = 0xFFFFFFFFu;
// dynamic shared memory a block may take without an opt-in attribute: 48
// KB less room for the static arrays
constexpr int64_t kSharedBytes = 47 * 1024;

template <bool kShared>
__device__ __forceinline__ void add(float *table, float *out, int64_t row,
                                    int c, int C, int M, float v) {
  if (row < 0 || row >= M) return;           // the dead tail of a tile
  if (kShared)
    atomicAdd(table + row * C + c, v);
  else
    atomicAdd(out + row * C + c, v);
}

template <typename Index, bool kShared>
__global__ void __launch_bounds__(kThreads) take_scatter_kernel(
    const float *__restrict__ grad, const Index *__restrict__ idx,
    float *__restrict__ out, int64_t n_rows, int K, int C, int M,
    int64_t rows_per_block) {
  extern __shared__ float smem[];
  float *table = smem;                                  // M * C (kShared)
  float *first_sum = smem + (kShared ? (int64_t)M * C : 0);  // kWarps * C
  float *last_sum = first_sum + kWarps * C;                  // kWarps * C
  __shared__ int64_t first_key[kWarps], last_key[kWarps];
  __shared__ int single[kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kShared) {
    for (int64_t i = threadIdx.x; i < (int64_t)M * C; i += kThreads)
      table[i] = 0.0f;
    __syncthreads();
  }
  const int64_t begin = blockIdx.x * rows_per_block;
  const int64_t end = begin + rows_per_block < n_rows
                          ? begin + rows_per_block : n_rows;
  const unsigned upto = (2u << lane) - 1u;   // lanes 0..lane (2u << 31 == 0)
  for (int64_t t0 = begin; t0 < end; t0 += kThreads) {
    const int64_t n = t0 + threadIdx.x;
    const bool valid = n < end;
    for (int k = 0; k < K; ++k) {
      // runs of equal indices among the warp's rows; the rows past the
      // end of the block's run form a run of key -1, which adds nothing
      const int64_t key = valid ? (int64_t)idx[n * K + k] : -1;
      const int64_t prev = __shfl_up_sync(kFull, key, 1);
      const bool head = lane == 0 || key != prev;
      const unsigned heads = __ballot_sync(kFull, head);
      const int run = __popc(heads & upto) - 1;
      const int n_runs = __popc(heads);
      const unsigned later = heads & ~upto;
      const int run_end = later ? __ffs(later) - 1 : 32;
      for (int c = 0; c < C; ++c) {
        float v = valid ? grad[(n * K + k) * C + c] : 0.0f;
        // each lane: the sum from itself to the end of its run
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float o = __shfl_down_sync(kFull, v, d);
          if (lane + d < run_end) v += o;
        }
        if (head) {
          if (run == 0)
            first_sum[warp * C + c] = v;
          else if (run == n_runs - 1)
            last_sum[warp * C + c] = v;
          else
            add<kShared>(table, out, key, c, C, M, v);
        }
      }
      if (lane == 0) {
        first_key[warp] = key;
        single[warp] = n_runs == 1;
      }
      if (head && run == n_runs - 1) last_key[warp] = key;
      __syncthreads();
      // join the runs that carry over from one warp to the next
      for (int c = threadIdx.x; c < C; c += kThreads) {
        int64_t open = -1;
        float sum = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          if (first_key[w] == open) {
            sum += first_sum[w * C + c];
          } else {
            add<kShared>(table, out, open, c, C, M, sum);
            open = first_key[w];
            sum = first_sum[w * C + c];
          }
          if (!single[w]) {
            add<kShared>(table, out, open, c, C, M, sum);
            open = last_key[w];
            sum = last_sum[w * C + c];
          }
        }
        add<kShared>(table, out, open, c, C, M, sum);
      }
      __syncthreads();
    }
  }
  if (kShared) {
    for (int64_t i = threadIdx.x; i < (int64_t)M * C; i += kThreads) {
      const float v = table[i];
      if (v != 0.0f) atomicAdd(out + i, v);
    }
  }
}

template <typename Index, bool kShared>
void launch(const float *grad, const void *idx, float *out, int64_t n,
            int K, int C, int M, int max_blocks, size_t smem,
            cudaStream_t stream) {
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const int64_t want = tiles < max_blocks ? tiles : max_blocks;
  const int64_t rows = (tiles + want - 1) / want * kThreads;
  const int blocks = (int)((n + rows - 1) / rows);
  take_scatter_kernel<Index, kShared><<<blocks, kThreads, smem, stream>>>(
      grad, (const Index *)idx, out, n, K, C, M, rows);
}

}  // namespace

// out (m, c), zeroed by the caller, += grad (n, k, c) at the rows idx
// (n, k) names (int64 if idx64, else int32), on `stream` -> the launch's
// CUDA error code. `shared` takes the table_shared mode, whose table must
// fit in 47 KB of shared memory beside the warps' runs.
extern "C" int rt_take_scatter(const float *grad, const void *idx, int idx64,
                               float *out, int64_t n, int64_t k, int64_t c,
                               int64_t m, int shared, cudaStream_t stream) {
  if (n == 0) return 0;
  if (n < 0 || k <= 0 || c <= 0 || m <= 0 || n * k >= (1ll << 31) ||
      m * c >= (1ll << 31) || c > kThreads)
    return (int)cudaErrorInvalidValue;
  const int64_t runs = 2ll * kWarps * c;
  const int64_t floats = shared ? m * c + runs : runs;
  if (floats * 4 > kSharedBytes) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)floats * 4;
  const int K = (int)k, C = (int)c, M = (int)m;
  if (shared && idx64)
    launch<int64_t, true>(grad, idx, out, n, K, C, M, kMaxBlocksShared, smem,
                          stream);
  else if (shared)
    launch<int32_t, true>(grad, idx, out, n, K, C, M, kMaxBlocksShared, smem,
                          stream);
  else if (idx64)
    launch<int64_t, false>(grad, idx, out, n, K, C, M, kMaxBlocksGlobal, smem,
                           stream);
  else
    launch<int32_t, false>(grad, idx, out, n, K, C, M, kMaxBlocksGlobal, smem,
                           stream);
  return (int)cudaGetLastError();
}
