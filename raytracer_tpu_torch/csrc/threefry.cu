// threefry2x32 random numbers for Hopper (sm_90a): core/rng's draws on the
// card, one thread per four outputs, each output one 20-round block in
// uint32 registers.
//
// Replaces no TPU kernel. The JAX package draws with jax.random, whose
// threefry XLA fuses into its consumers; the port's plain version
// (raytracer_tpu_torch/core/rng.py:_threefry2x32) runs the block as masked
// int64 torch operations, about 170 eager launches a draw, each reading and
// writing 8-byte words over the whole batch. Here a draw is one launch that
// writes each output once. The arithmetic is exact integer arithmetic, so
// the kernel and the plain version agree bit for bit:
//  * counter pair (0, c) per output, key (k1, k2), the two output words
//    XORed: jax's partitionable random_bits;
//  * c is the output's flat index within its key's draw, or, for a draw of
//    wavefronts of `seg` rays laid end to end along an axis of length
//    `dim` (core/rng.uniform_segmented), the index it has in one segment:
//    (outer * seg + r % seg) * inner + i for the output (outer, r, i) with
//    `inner` elements after the axis; or, for fold_in of a tensor, the
//    data word itself;
//  * a key is two host words, or per output run of `per_key` a pair of
//    int64 words holding uint32 values (a batch of keys);
//  * modes: UNIFORM, float32 from the top 23 bits as a mantissa in [1, 2)
//    minus one (jax.random.uniform); BITS, the uint32 word as int64;
//    PAIR, both words as int64 (a batch of keys out of fold_in or split).
//
// What bounds it on the H100: its integer operations. A block is about 80
// of them (20 rounds of add, rotate and xor; five key injections) against
// 4 bytes written for a float32, so at the white paper's 33.5e12 int32
// operations/s against 3.35 TB/s the operations take twice as long as the
// stores. The design keeps everything in registers (no shared memory, no
// loads on the cells' path, whose keys are host words), rotates with the
// funnel shift, writes four outputs a thread with one 16-byte store (two
// for int64), and walks the output in a grid-stride loop on PyTorch's
// current stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;            // outputs a thread a step: one float4
constexpr int kMaxBlocks = 132 * 16;

enum Mode { kUniform = 0, kBits = 1, kPair = 2 };

struct Draw {
  uint32_t s1, s2;                 // the key's words, when kb1 is null
  const int64_t *kb1, *kb2;        // a batch of keys, one per per_key outputs
  const void *data;                // fold_in's data words, or null
  int data64;                      // data is int64 (else int32)
  uint32_t n, per_key, dim, seg, inner;
  void *out1, *out2;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// The 20-round threefry2x32 block of core/rng._threefry2x32 on (x1, x2).
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2,
                                         uint32_t &x1, uint32_t &x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
#define RT_ROUND(r) x1 += x2; x2 = rotl(x2, r) ^ x1;
#define RT_ROUNDS_A RT_ROUND(13) RT_ROUND(15) RT_ROUND(26) RT_ROUND(6)
#define RT_ROUNDS_B RT_ROUND(17) RT_ROUND(29) RT_ROUND(16) RT_ROUND(24)
  x1 += k1; x2 += k2;
  RT_ROUNDS_A x1 += k2; x2 += k3 + 1u;
  RT_ROUNDS_B x1 += k3; x2 += k1 + 2u;
  RT_ROUNDS_A x1 += k1; x2 += k2 + 3u;
  RT_ROUNDS_B x1 += k2; x2 += k3 + 4u;
  RT_ROUNDS_A x1 += k3; x2 += k1 + 5u;
#undef RT_ROUNDS_B
#undef RT_ROUNDS_A
#undef RT_ROUND
}

__device__ __forceinline__ uint32_t counter(const Draw &a, uint32_t i) {
  if (a.data)
    return a.data64 ? (uint32_t)((const int64_t *)a.data)[i]
                    : (uint32_t)((const int32_t *)a.data)[i];
  const uint32_t w = a.per_key == a.n ? i : i % a.per_key;
  if (a.seg == a.dim) return w;
  const uint32_t q = w / a.inner;
  return ((q / a.dim) * a.seg + (q % a.dim) % a.seg) * a.inner + w % a.inner;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) threefry_kernel(Draw a) {
  const uint32_t stride = gridDim.x * kThreads * kPer;
  for (uint32_t base = (blockIdx.x * kThreads + threadIdx.x) * kPer;
       base < a.n; base += stride) {
    uint32_t v1[kPer], v2[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const uint32_t i = base + j;
      uint32_t k1 = a.s1, k2 = a.s2;
      if (a.kb1) {
        const uint32_t k = i < a.n ? i / a.per_key : 0;
        k1 = (uint32_t)a.kb1[k];
        k2 = (uint32_t)a.kb2[k];
      }
      uint32_t x1 = 0u, x2 = i < a.n ? counter(a, i) : 0u;
      threefry(k1, k2, x1, x2);
      v1[j] = x1;
      v2[j] = x2;
    }
    const bool whole = base + kPer <= a.n;
    if (MODE == kUniform) {
      float f[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        f[j] = __uint_as_float(((v1[j] ^ v2[j]) >> 9) | 0x3F800000u) - 1.0f;
      float *out = (float *)a.out1 + base;
      if (whole) {
        *(float4 *)out = make_float4(f[0], f[1], f[2], f[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (base + j < a.n) out[j] = f[j];
      }
    } else if (MODE == kBits) {
      long long b[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = (long long)(v1[j] ^ v2[j]);
      long long *out = (long long *)a.out1 + base;
      if (whole) {
        ((longlong2 *)out)[0] = make_longlong2(b[0], b[1]);
        ((longlong2 *)out)[1] = make_longlong2(b[2], b[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (base + j < a.n) out[j] = b[j];
      }
    } else {
      long long *o1 = (long long *)a.out1 + base;
      long long *o2 = (long long *)a.out2 + base;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (base + j < a.n) {
          o1[j] = (long long)v1[j];
          o2[j] = (long long)v2[j];
        }
      }
    }
  }
}

}  // namespace

// One draw of n outputs (n < 2^31, a multiple of per_key; dim a multiple
// of seg) on `stream` -> the launch's CUDA error code. out1 (and out2 for
// PAIR) must be 16-byte aligned.
extern "C" int rt_threefry(int mode, uint32_t s1, uint32_t s2,
                           const int64_t *kb1, const int64_t *kb2,
                           const void *data, int data64, int64_t n,
                           int64_t per_key, int64_t dim, int64_t seg,
                           int64_t inner, void *out1, void *out2,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31) || per_key <= 0 || seg <= 0 || dim <= 0 ||
      inner <= 0 || n % per_key || dim % seg || (!kb1) != (!kb2))
    return (int)cudaErrorInvalidValue;
  const Draw a{s1, s2, kb1, kb2, data, data64, (uint32_t)n,
               (uint32_t)per_key, (uint32_t)dim, (uint32_t)seg,
               (uint32_t)inner, out1, out2};
  long long want = (n + kThreads * kPer - 1) / (kThreads * kPer);
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  switch (mode) {
    case kUniform:
      threefry_kernel<kUniform><<<blocks, kThreads, 0, stream>>>(a);
      break;
    case kBits:
      threefry_kernel<kBits><<<blocks, kThreads, 0, stream>>>(a);
      break;
    case kPair:
      threefry_kernel<kPair><<<blocks, kThreads, 0, stream>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
