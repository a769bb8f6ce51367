// Wide-BVH tracer for Hopper (sm_90a): one thread per ray, each walking
// the merged node pool of geometry/bvh.py with its own short stack.
//
// Replaces raytracer_tpu/ops/traverse.py:bvh_trace, which is not a Pallas
// kernel but an XLA while-loop under vmap (the JAX package's tracer off the
// TPU), in all its modes: nearest hit; any-hit (the first hit found ends the
// ray); the test counters of collect_stats; motion blur; alpha cutouts; and
// two-level scenes, whose instance leaves push (BLAS root, instance) pairs
// onto a second stack. It follows the plain PyTorch version
// (raytracer_tpu_torch/ops/traverse.py) pop for pop, so the two agree bit for
// bit: t, tri, inst, a, b and the counters. Built with -fmad=false, every
// multiply and add rounds on its own, as in the plain version; the clamped
// reciprocal and the Moller-Trumbore test are trace_common.cuh's
// (rt::rcp_clamped, rt::mt_hit), whose float order is traverse.py's.
//
// Where the two could part, and what this kernel does:
//  * Visiting order, which decides exact ties in t. Within a node the
//    triangle leaves are one (B x kMaxLeaf)-lane batch in (slot, lane)
//    order, and the batch's hit is the smallest t, the lowest lane on equal
//    t (jnp.argmin, traverse.py:141): here the lanes run in that order and
//    a hit replaces the node's best only with t strictly below it, starting
//    from limit = min(best_t, tmax), which gives the same lane. Instance
//    leaves are pushed first, slot by slot and lane by lane (:153-166);
//    internal children after them, far first, in the stable order of -near
//    with -inf for the other slots (:170-180): a slot's rank counts the
//    slots of larger key and the earlier slots of equal key
//    (traverse._push_order), so among equal near the higher slot is pushed
//    first and popped last.
//  * Empty slots (count == -1) hold (+inf, -inf) boxes (FLT_MAX from the
//    native build). Their slab test passes with near = -inf, so only the
//    count leaves them out, and the box counter adds all B slots a visit.
//    The slab terms stay free of NaN for finite rays (|1/d| <= 1e20 after
//    the clamp, never 0), so fminf/fmaxf, which drop a NaN, agree with
//    torch.minimum/maximum and jnp.max, which propagate one.
//  * The stack bound S = depth (B - 1) + B kMaxLeaf + 4 (traverse.py:57) is
//    the worst case; the wrapper raises when a scene's S exceeds its limit
//    and never truncates. A write past S is dropped and a read clamps, as
//    jnp's scatter and gather do (never reached).
//  * The triangle records hold e1 = p1 - p0 and e2 = p2 - p0, computed by
//    the wrapper in float32 on the card: the same one rounding each as the
//    subtraction here would make, so rt::mt_hit sees the same operands.
//  * Motion blur lerps each corner, p0 + time (q0 - p0) (:126-133), also in
//    a prototype's object space, then takes the edges.
//  * Alpha maps are tested inside the walk (:137-139): the bilinear lookup
//    of alpha_at is shading/textures.tex_lookup's, operation for operation.
//    The alpha march of the cluster tracers is not used: its restart past a
//    rejected hit could skip an opaque triangle at exactly the same t, which
//    this visiting rule keeps.
//  * A miss returns t = kTmax (:204).
//
// What bounds it on the H100: the box and triangle tests are float32
// operations (24 a box, 45 and a divide a triangle), and the bytes are a
// ray's 56 in and out plus the tables once, yet the kernel runs at a few
// percent of that bound (PERF.md, row 5). A ray's walk is serial and
// data-dependent: each visit waits on its stack, then on the node's fetch,
// then on its leaves'; and a warp's 32 rays take paths of other lengths
// through other leaves, so it issues each visit's instructions once for
// all of them and waits on its longest ray. It is bound by the latency of
// those dependent loads and by the warp's divergence. What the design does
// about it:
//  * One 128-byte record a node (ops/cuda/bvh_kernel.node_records): the B
//    children's boxes as six float4 rows (lo x, y, z, hi x, y, z), then
//    child and count as int4s; one cache line, eight 16-byte loads, where
//    the (N, B, 3) and (N, B) tables took some 20 scalar loads over four
//    lines.
//  * Triangle records in prim_order's order (bvh_kernel.tri_records):
//    lane k of a leaf reads slot child + k, (p0 | tri id, e1, e2) as three
//    float4s, or the six corners at t0 and t1 with motion blur, instead of
//    the chain prim_order -> face_v -> nine vertex floats. Instance slots
//    of two-level leaves still read prim_order and inst_root.
//  * The stack in shared memory, laid out [slot][thread] so that a warp's
//    lanes fall on 32 banks: the first K = min(S, 32) entries of each ray
//    (bvh_kernel.SHARED), the rest in a scratch tensor laid out
//    [slot][ray] (a sponza ray uses about 13 of its 71), where a local
//    array indexed by the stack pointer would sit in local memory. Every
//    small array here is indexed by constants after unrolling, so the
//    stack frame is empty.
//  * A node's triangle leaves are one loop over the lane's own triangles
//    in (slot, lane) order, so the warp passes over the most triangles one
//    lane has, not over the most of each slot in turn.
//  * The ray's reciprocal direction is computed once, and again only when
//    a pop enters another instance's frame; the children's pushes take
//    their places from their ranks, four stores at most.
// Tried and dropped, for they did not pay on the card: persistent warps
// fetching rays from a global counter (Aila and Laine 2009), 32 at a time
// or a lane at a time; the whole stack in shared memory (K = S: less L1
// for the records); prefetching the next node and the leaves' records into
// L1 around the pushes.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "trace_common.cuh"

// The kernel's arguments: the wrapper's ctypes.Structure `_Args`
// (ops/cuda/bvh_kernel.py), field for field. Outside the anonymous
// namespace, so that rt_bvh_trace, which takes it, keeps external linkage.
struct Args {
  const float4* nodes;     // (N, 8) float4: the node records
  const float4* tris;      // (P, 3) float4, (P, 6) with motion blur
  const int* prim_order;   // (P,), two-level only
  const float4* m_inv;     // (I, 3) float4 rows, two-level only
  const int* inst_root;    // (I,)
  const int* face_mat;     // alpha maps only, down to tex_chan
  const int* tex_alpha;
  const int* face_t;
  const unsigned char* face_has_uv;
  const float* texcoords;
  const float* tex_data;
  const int* tex_off;
  const int* tex_w;
  const int* tex_h;
  const int* tex_chan;
  const float* o;          // (R, 3)
  const float* d;
  const float* time;       // (R,)
  const float* tmin;
  const float* tmax;
  float* t_out;            // (R,)
  int* tri_out;
  int* inst_out;
  float* a_out;
  float* b_out;
  int* n_box;              // (R,), collect_stats only
  int* n_tri;
  int* spill;              // (1 or 2, S - K, R) with S > K, else null
  int n_prim;
  int n_inst;
  int n_texel;
  int R;
  int root;
  int S;
  int K;
  int any_hit;
  int stats;
};

namespace {

using rt::kTmax;

constexpr int kThreads = 128;
constexpr int kB = 4;          // branching factor of the build (bvh.py)
constexpr int kMaxLeaf = 4;    // traverse.MAX_LEAF
constexpr int kNodeF4 = 8;     // float4s a node record

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// component c (a constant after unrolling) of a float4 or int4
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ int comp(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The alpha-map value at (tri, a, b): intersect.alpha_of, then
// textures.tex_lookup's alpha channel (wrap, v flip, bilinear over the four
// tiled corners, alpha 1 where a texture has fewer than 4 channels); 1
// where the material has no alpha map.
__device__ __forceinline__ float alpha_at(const Args& A, int tri, float a,
                                          float b) {
  const int tex = A.tex_alpha[A.face_mat[tri]];
  if (tex < 0 || A.n_texel == 0) return 1.f;
  float u = a, v = b;
  if (A.face_has_uv[tri]) {
    const int* ft = A.face_t + 3 * tri;
    const float* t0 = A.texcoords + 2 * ft[0];
    const float* t1 = A.texcoords + 2 * ft[1];
    const float* t2 = A.texcoords + 2 * ft[2];
    const float c = (1.f - a) - b;
    u = (t0[0] * c + t1[0] * a) + t2[0] * b;
    v = (t0[1] * c + t1[1] * a) + t2[1] * b;
  }
  const int off = A.tex_off[tex], w = A.tex_w[tex], h = A.tex_h[tex];
  const int ch = A.tex_chan[tex];
  u = u - truncf(u);
  v = v - truncf(v);
  if (u < 0.f) u = u + 1.f;
  if (v < 0.f) v = v + 1.f;
  v = 1.f - v;
  const float px = u * (float)w, py = v * (float)h;
  const float fx = floorf(px), fy = floorf(py);
  const float dx = px - fx, dy = py - fy;
  const int x1 = (int)fx, y1 = (int)fy;
  const int kc = min(3, ch - 1);
  float q[4];   // (x1, y1), (x1 + 1, y1), (x1, y1 + 1), (x1 + 1, y1 + 1)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = ((x1 + (k & 1)) % w + w) % w;
    const int y = ((y1 + (k >> 1)) % h + h) % h;
    const int idx = clampi(off + (y * w + x) * ch + kc, 0, A.n_texel - 1);
    q[k] = ch >= 4 ? A.tex_data[idx] : 1.f;
  }
  const float q1 = q[0] * (1.f - dx) + q[1] * dx;
  const float q2 = q[2] * (1.f - dx) + q[3] * dx;
  return q1 * (1.f - dy) + q2 * dy;
}

// The ray's stack: slot s < K in shared memory at sh[s kThreads], slot
// s >= K in the spill at A.spill[(s - K) R + r]; the instance of each
// entry (two levels) K slots, or (S - K) R entries, further on. K, S and R
// are read from the kernel's parameters, which take no registers.
template <bool kTwo>
__device__ __forceinline__ void put(const Args& A, int* sh, int r, int s,
                                    int node, int inst) {
  if (s >= A.S) return;
  if (s < A.K) {
    sh[s * kThreads] = node;
    if (kTwo) sh[(A.K + s) * kThreads] = inst;
  } else {
    int* gl = A.spill + (size_t)(s - A.K) * A.R + r;
    *gl = node;
    if (kTwo) gl[(size_t)(A.S - A.K) * A.R] = inst;
  }
}

template <bool kTwo>
__device__ __forceinline__ void get(const Args& A, const int* sh, int r,
                                    int s, int& node, int& inst) {
  s = min(s, A.S - 1);
  if (s < A.K) {
    node = sh[s * kThreads];
    if (kTwo) inst = sh[(A.K + s) * kThreads];
  } else {
    const int* gl = A.spill + (size_t)(s - A.K) * A.R + r;
    node = *gl;
    if (kTwo) inst = gl[(size_t)(A.S - A.K) * A.R];
  }
}

// (kThreads, 1): ptxas left to its default spilled 12-20 bytes in some
// instances; with the bound given it keeps them all in registers
template <bool kTwo, bool kMB, bool kAlpha>
__global__ void __launch_bounds__(kThreads, 1)
    bvh_kernel(const __grid_constant__ Args A) {
  extern __shared__ int stack_sh[];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= A.R) return;
  int* sh = stack_sh + threadIdx.x;
  const float time = A.time[r], tmin = A.tmin[r], tmax = A.tmax[r];
  // the ray in the frame of instance `frame` (-1: the world) and its
  // clamped reciprocal direction, recomputed (from the world ray, read
  // again) only when the frame changes
  float ox = A.o[3 * r], oy = A.o[3 * r + 1], oz = A.o[3 * r + 2];
  float dx = A.d[3 * r], dy = A.d[3 * r + 1], dz = A.d[3 * r + 2];
  float ix = rt::rcp_clamped(dx), iy = rt::rcp_clamped(dy),
        iz = rt::rcp_clamped(dz);
  int frame = -1;
  float best_t = fminf(tmax, kTmax), best_a = 0.f, best_b = 0.f;
  int best_tri = -1, best_inst = 0, nbox = 0, ntri = 0, sp = 1;
  put<kTwo>(A, sh, r, 0, A.root, -1);

  while (sp > 0 && !(A.any_hit && best_tri >= 0)) {
    // ---- one visit: pop a node
    --sp;
    int node, iid = 0;
    get<kTwo>(A, sh, r, sp, node, iid);
    if (kTwo && iid != frame) {
      frame = iid;
      const float wox = A.o[3 * r], woy = A.o[3 * r + 1],
                  woz = A.o[3 * r + 2];
      const float wdx = A.d[3 * r], wdy = A.d[3 * r + 1],
                  wdz = A.d[3 * r + 2];
      ox = wox; oy = woy; oz = woz; dx = wdx; dy = wdy; dz = wdz;
      if (iid >= 0) {   // vecmath.transform_point / transform_vector
        const float4 m0 = __ldg(A.m_inv + 3 * iid);
        const float4 m1 = __ldg(A.m_inv + 3 * iid + 1);
        const float4 m2 = __ldg(A.m_inv + 3 * iid + 2);
        dx = (m0.x * wdx + m0.y * wdy) + m0.z * wdz;
        dy = (m1.x * wdx + m1.y * wdy) + m1.z * wdz;
        dz = (m2.x * wdx + m2.y * wdy) + m2.z * wdz;
        ox = ((m0.x * wox + m0.y * woy) + m0.z * woz) + m0.w;
        oy = ((m1.x * wox + m1.y * woy) + m1.z * woz) + m1.w;
        oz = ((m2.x * wox + m2.y * woy) + m2.z * woz) + m2.w;
      }
      ix = rt::rcp_clamped(dx);
      iy = rt::rcp_clamped(dy);
      iz = rt::rcp_clamped(dz);
    }
    const float limit = fminf(best_t, tmax);

    // ---- the node record: the B child slabs
    const float4* nr = A.nodes + kNodeF4 * node;
    const float4 lx = __ldg(nr), ly = __ldg(nr + 1), lz = __ldg(nr + 2);
    const float4 hx = __ldg(nr + 3), hy = __ldg(nr + 4), hz = __ldg(nr + 5);
    const int4 chd4 = __ldg(reinterpret_cast<const int4*>(nr + 6));
    const int4 cnt4 = __ldg(reinterpret_cast<const int4*>(nr + 7));
    float near[kB];
    bool slab[kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      const float tx0 = (comp(lx, c) - ox) * ix;
      const float tx1 = (comp(hx, c) - ox) * ix;
      const float ty0 = (comp(ly, c) - oy) * iy;
      const float ty1 = (comp(hy, c) - oy) * iy;
      const float tz0 = (comp(lz, c) - oz) * iz;
      const float tz1 = (comp(hz, c) - oz) * iz;
      const float n = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fminf(tz0, tz1));
      const float f = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
      near[c] = n;
      slab[c] = n <= f && f >= tmin && n <= limit;
    }
    nbox += kB;

    // ---- triangle leaves: the lane's up to B x kMaxLeaf triangles in
    // (slot, lane) order as one loop, so that the warp passes over the
    // most triangles any lane has, not over the most of each slot in turn
    int ln[kB];
    int total = 0;
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      const int cnt = comp(cnt4, c);
      ln[c] = slab[c] && cnt > 0 ? min(cnt, kMaxLeaf) : 0;
      total += ln[c];
    }
    ntri += total;
    float cur = limit, wa = 0.f, wb = 0.f;
    int win = -1;
    int sc = 0, sk = 0;   // the slot and lane of the next triangle
    for (int i = 0; i < total; ++i) {
      while (sk >= (sc == 0 ? ln[0] : sc == 1 ? ln[1] : sc == 2 ? ln[2]
                                                                : ln[3])) {
        ++sc;
        sk = 0;
      }
      const int slot = clampi(comp(chd4, sc) + sk, 0, A.n_prim - 1);
      ++sk;
      float p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z;
      int tri;
      if (!kMB) {
        const float4* tr = A.tris + 3 * slot;
        const float4 a0 = __ldg(tr), a1 = __ldg(tr + 1), a2 = __ldg(tr + 2);
        tri = __float_as_int(a0.w);
        p0x = a0.x; p0y = a0.y; p0z = a0.z;
        e1x = a1.x; e1y = a1.y; e1z = a1.z;
        e2x = a2.x; e2y = a2.y; e2z = a2.z;
      } else {
        const float4* tr = A.tris + 6 * slot;
        const float4 a0 = __ldg(tr), a1 = __ldg(tr + 1), a2 = __ldg(tr + 2);
        const float4 b0 = __ldg(tr + 3), b1 = __ldg(tr + 4),
                     b2 = __ldg(tr + 5);
        tri = __float_as_int(a0.w);
        p0x = a0.x + time * (b0.x - a0.x);
        p0y = a0.y + time * (b0.y - a0.y);
        p0z = a0.z + time * (b0.z - a0.z);
        const float p1x = a1.x + time * (b1.x - a1.x);
        const float p1y = a1.y + time * (b1.y - a1.y);
        const float p1z = a1.z + time * (b1.z - a1.z);
        const float p2x = a2.x + time * (b2.x - a2.x);
        const float p2y = a2.y + time * (b2.y - a2.y);
        const float p2z = a2.z + time * (b2.z - a2.z);
        e1x = p1x - p0x; e1y = p1y - p0y; e1z = p1z - p0z;
        e2x = p2x - p0x; e2y = p2y - p0y; e2z = p2z - p0z;
      }
      float t, a, b;
      if (!rt::mt_hit(ox, oy, oz, dx, dy, dz, p0x, p0y, p0z, e1x, e1y,
                      e1z, e2x, e2y, e2z, tmin, cur, t, a, b))
        continue;
      if (kAlpha && !(alpha_at(A, tri, a, b) >= 0.5f)) continue;
      cur = t;
      win = tri;
      wa = a;
      wb = b;
    }
    if (win >= 0) {
      best_t = cur;
      best_tri = win;
      best_inst = max(iid, 0);
      best_a = wa;
      best_b = wb;
    }

    // ---- instance leaves: (BLAS root, instance), slot by slot
    if (kTwo) {
#pragma unroll
      for (int c = 0; c < kB; ++c) {
        const int cnt = comp(cnt4, c);
        if (!slab[c] || cnt > -2) continue;
        const int n = min(-(cnt + 1), kMaxLeaf);
        for (int k = 0; k < n; ++k) {
          const int ii =
              A.prim_order[clampi(comp(chd4, c) + k, 0, A.n_prim - 1)];
          put<kTwo>(A, sh, r, sp++,
                    A.inst_root[clampi(ii, 0, A.n_inst - 1)], ii);
        }
      }
    }

    // ---- internal children, far first: child c goes to the place its
    // rank gives it among the internal children, the count of those of
    // larger near and of earlier slots of equal near (traverse._push_order)
    bool inner[kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) inner[c] = slab[c] && comp(cnt4, c) == 0;
    int pushed = 0;
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      int pos = 0;
#pragma unroll
      for (int j = 0; j < kB; ++j)
        if (j != c)
          pos += inner[j] && (near[j] > near[c] ||
                              (j < c && near[j] == near[c]));
      if (inner[c]) {
        put<kTwo>(A, sh, r, sp + pos, comp(chd4, c), iid);
        ++pushed;
      }
    }
    sp += pushed;
  }
  A.t_out[r] = best_tri >= 0 ? best_t : kTmax;
  A.tri_out[r] = best_tri;
  A.inst_out[r] = best_inst;
  A.a_out[r] = best_a;
  A.b_out[r] = best_b;
  if (A.stats) {
    A.n_box[r] = nbox;
    A.n_tri[r] = ntri;
  }
}

template <bool kTwo, bool kMB, bool kAlpha>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int smem = a.K * kThreads * (int)sizeof(int) * (kTwo ? 2 : 1);
  const cudaError_t e = cudaFuncSetAttribute(
      bvh_kernel<kTwo, kMB, kAlpha>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.R + kThreads - 1) / kThreads;
  bvh_kernel<kTwo, kMB, kAlpha><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kTwo, bool kMB>
cudaError_t launch_alpha(const Args& a, bool alpha, cudaStream_t s) {
  return alpha ? launch<kTwo, kMB, true>(a, s)
               : launch<kTwo, kMB, false>(a, s);
}

}  // namespace

// Trace a->R rays; two_level, mb and alpha select the kernel. Returns the
// launch's CUDA error code (0 on success).
extern "C" int rt_bvh_trace(const Args* a, int two_level, int mb, int alpha,
                            cudaStream_t stream) {
  if (a->R == 0) return 0;
  if (a->K < 1 || a->K > a->S || (a->S > a->K && a->spill == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (two_level)
    e = mb ? launch_alpha<true, true>(*a, alpha, stream)
           : launch_alpha<true, false>(*a, alpha, stream);
  else
    e = mb ? launch_alpha<false, true>(*a, alpha, stream)
           : launch_alpha<false, false>(*a, alpha, stream);
  return (int)e;
}
