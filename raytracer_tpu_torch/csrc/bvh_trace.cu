// Wide-BVH tracer for Hopper (sm_90a): one thread per ray, each walking the
// merged node pool of geometry/bvh.py with its own short stack.
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
//    with -inf for the other slots (:170-180), so among equal near the
//    higher slot is pushed first and popped last: the push loop takes the
//    largest key left, the lowest slot on a tie.
//  * Empty slots (count == -1) hold (+inf, -inf) boxes (FLT_MAX from the
//    native build). Their slab test passes with near = -inf, so only the
//    count leaves them out, and the box counter adds all B slots a visit.
//    The slab terms stay free of NaN for finite rays (|1/d| <= 1e20 after
//    the clamp, never 0), so fminf/fmaxf, which drop a NaN, agree with
//    torch.minimum/maximum and jnp.max, which propagate one.
//  * The stack bound S = depth (B - 1) + B kMaxLeaf + 4 (traverse.py:57) is
//    the worst case. The stacks are fixed arrays of kStack entries; the
//    wrapper raises when a scene's S exceeds kStack and never truncates. A
//    write past S is dropped and a read clamps, as jnp's scatter and gather
//    do (never reached).
//  * Motion blur lerps each corner, p0 + time (q0 - p0) (:126-133), also in
//    a prototype's object space.
//  * Alpha maps are tested inside the walk (:137-139): the bilinear lookup
//    of alpha_at is shading/textures.tex_lookup's, operation for operation.
//    The alpha march of the cluster tracers is not used: its restart past a
//    rejected hit could skip an opaque triangle at exactly the same t, which
//    this visiting rule keeps.
//  * A miss returns t = kTmax (:204).
//
// What bounds it on the H100: the box and triangle tests are float32
// operations (24 a box, 45 and a divide a triangle), but a thread's walk is
// serial and data-dependent: its node fetches are scattered 96-byte reads
// of the (N, B, 3) boxes, its triangles gathers through prim_order and
// face_v, and a warp's 32 rays diverge in path and length. So it is bound
// by latency, not by its operations or bytes. This first version keeps the
// stacks in local memory and stages nothing; a warp-coherent walk with
// staged nodes is later work (ROADMAP queue 2).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "trace_common.cuh"

// The kernel's arguments: the wrapper's ctypes.Structure `_Args`
// (ops/cuda/bvh_kernel.py), field for field. Outside the anonymous
// namespace, so that rt_bvh_trace, which takes it, keeps external linkage.
struct Args {
  const float* node_min;   // (N, B, 3)
  const float* node_max;
  const int* child;        // (N, B)
  const int* count;
  const int* prim_order;   // (P,)
  const int* face_v;       // (T, 3)
  const float* verts;      // (V, 3)
  const float* verts_t1;   // (V, 3), motion blur only
  const float* m_inv;      // (I, 3, 4), two-level only
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
  int n_prim;
  int n_inst;
  int n_texel;
  int R;
  int root;
  int S;
  int any_hit;
  int stats;
};

namespace {

using rt::kTmax;

constexpr int kThreads = 128;
constexpr int kB = 4;          // branching factor of the build (bvh.py)
constexpr int kMaxLeaf = 4;    // traverse.MAX_LEAF
constexpr int kStack = 256;    // bvh_kernel.STACK

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The alpha-map value at (tri, a, b): intersect.alpha_of, then
// textures.tex_lookup's alpha channel (wrap, v flip, bilinear over the four
// tiled corners, alpha 1 where a texture has fewer than 4 channels); 1
// where the material has no alpha map.
__device__ float alpha_at(const Args& A, int tri, float a, float b) {
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

template <bool kTwo, bool kMB, bool kAlpha>
__global__ void __launch_bounds__(kThreads) bvh_kernel(const Args A) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= A.R) return;
  const float wox = A.o[3 * r], woy = A.o[3 * r + 1], woz = A.o[3 * r + 2];
  const float wdx = A.d[3 * r], wdy = A.d[3 * r + 1], wdz = A.d[3 * r + 2];
  const float time = A.time[r], tmin = A.tmin[r], tmax = A.tmax[r];
  const int S = A.S;
  int stack_n[kStack];
  int stack_i[kTwo ? kStack : 1];
  int sp = 1;
  stack_n[0] = A.root;
  if (kTwo) stack_i[0] = -1;
  float best_t = fminf(tmax, kTmax), best_a = 0.f, best_b = 0.f;
  int best_tri = -1, best_inst = 0, nbox = 0, ntri = 0;

  while (sp > 0 && !(A.any_hit && best_tri >= 0)) {
    --sp;
    const int at = min(sp, S - 1);
    const int node = stack_n[at];
    int iid = 0;
    float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
    if (kTwo) {
      iid = stack_i[at];
      if (iid >= 0) {   // vecmath.transform_point / transform_vector
        const float* m = A.m_inv + 12 * iid;
        dx = (m[0] * wdx + m[1] * wdy) + m[2] * wdz;
        dy = (m[4] * wdx + m[5] * wdy) + m[6] * wdz;
        dz = (m[8] * wdx + m[9] * wdy) + m[10] * wdz;
        ox = ((m[0] * wox + m[1] * woy) + m[2] * woz) + m[3];
        oy = ((m[4] * wox + m[5] * woy) + m[6] * woz) + m[7];
        oz = ((m[8] * wox + m[9] * woy) + m[10] * woz) + m[11];
      }
    }
    const float ix = rt::rcp_clamped(dx), iy = rt::rcp_clamped(dy),
                iz = rt::rcp_clamped(dz);
    const float limit = fminf(best_t, tmax);

    // ---- the B child slabs
    float near[kB];
    bool slab[kB];
    int cnt[kB], chd[kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      const float* lo = A.node_min + 3 * (node * kB + c);
      const float* hi = A.node_max + 3 * (node * kB + c);
      const float tx0 = (lo[0] - ox) * ix, tx1 = (hi[0] - ox) * ix;
      const float ty0 = (lo[1] - oy) * iy, ty1 = (hi[1] - oy) * iy;
      const float tz0 = (lo[2] - oz) * iz, tz1 = (hi[2] - oz) * iz;
      const float n = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fminf(tz0, tz1));
      const float f = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
      near[c] = n;
      slab[c] = n <= f && f >= tmin && n <= limit;
      cnt[c] = A.count[node * kB + c];
      chd[c] = A.child[node * kB + c];
    }
    nbox += kB;

    // ---- triangle leaves, lanes in (slot, lane) order
    float cur = limit, wa = 0.f, wb = 0.f;
    int win = -1;
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      if (!slab[c] || cnt[c] <= 0) continue;
      const int n = min(cnt[c], kMaxLeaf);
      ntri += n;
      for (int k = 0; k < n; ++k) {
        const int tri = A.prim_order[clampi(chd[c] + k, 0, A.n_prim - 1)];
        const int* f = A.face_v + 3 * tri;
        const float* v0 = A.verts + 3 * f[0];
        const float* v1 = A.verts + 3 * f[1];
        const float* v2 = A.verts + 3 * f[2];
        float p0x = v0[0], p0y = v0[1], p0z = v0[2];
        float p1x = v1[0], p1y = v1[1], p1z = v1[2];
        float p2x = v2[0], p2y = v2[1], p2z = v2[2];
        if (kMB) {
          const float* q0 = A.verts_t1 + 3 * f[0];
          const float* q1 = A.verts_t1 + 3 * f[1];
          const float* q2 = A.verts_t1 + 3 * f[2];
          p0x = p0x + time * (q0[0] - p0x);
          p0y = p0y + time * (q0[1] - p0y);
          p0z = p0z + time * (q0[2] - p0z);
          p1x = p1x + time * (q1[0] - p1x);
          p1y = p1y + time * (q1[1] - p1y);
          p1z = p1z + time * (q1[2] - p1z);
          p2x = p2x + time * (q2[0] - p2x);
          p2y = p2y + time * (q2[1] - p2y);
          p2z = p2z + time * (q2[2] - p2z);
        }
        float t, a, b;
        if (!rt::mt_hit(ox, oy, oz, dx, dy, dz, p0x, p0y, p0z, p1x - p0x,
                        p1y - p0y, p1z - p0z, p2x - p0x, p2y - p0y,
                        p2z - p0z, tmin, cur, t, a, b))
          continue;
        if (kAlpha && !(alpha_at(A, tri, a, b) >= 0.5f)) continue;
        cur = t;
        win = tri;
        wa = a;
        wb = b;
      }
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
        if (!slab[c] || cnt[c] > -2) continue;
        const int n = min(-(cnt[c] + 1), kMaxLeaf);
        for (int k = 0; k < n; ++k) {
          const int ii = A.prim_order[clampi(chd[c] + k, 0, A.n_prim - 1)];
          if (sp < S) {
            stack_n[sp] = A.inst_root[clampi(ii, 0, A.n_inst - 1)];
            stack_i[sp] = ii;
          }
          ++sp;
        }
      }
    }

    // ---- internal children, far first: the largest near left, the
    // lowest slot on a tie
    bool used[kB] = {};
#pragma unroll
    for (int pos = 0; pos < kB; ++pos) {
      int pick = -1;
      float key = 0.f;
#pragma unroll
      for (int c = 0; c < kB; ++c) {
        const float kc = slab[c] && cnt[c] == 0 ? near[c] : -CUDART_INF_F;
        if (!used[c] && (pick < 0 || kc > key)) {
          pick = c;
          key = kc;
        }
      }
      used[pick] = true;
      if (slab[pick] && cnt[pick] == 0) {
        if (sp < S) {
          stack_n[sp] = chd[pick];
          if (kTwo) stack_i[sp] = iid;
        }
        ++sp;
      }
    }
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

template <bool kTwo, bool kMB>
void launch_alpha(const Args& a, bool alpha, int blocks, cudaStream_t s) {
  if (alpha)
    bvh_kernel<kTwo, kMB, true><<<blocks, kThreads, 0, s>>>(a);
  else
    bvh_kernel<kTwo, kMB, false><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

// Trace a->R rays; two_level, mb and alpha select the kernel. Returns the
// launch's CUDA error code (0 on success).
extern "C" int rt_bvh_trace(const Args* a, int two_level, int mb, int alpha,
                            cudaStream_t stream) {
  if (a->R == 0) return 0;
  if (a->S > kStack) return (int)cudaErrorInvalidValue;
  const int blocks = (a->R + kThreads - 1) / kThreads;
  if (two_level) {
    if (mb) launch_alpha<true, true>(*a, alpha, blocks, stream);
    else launch_alpha<true, false>(*a, alpha, blocks, stream);
  } else {
    if (mb) launch_alpha<false, true>(*a, alpha, blocks, stream);
    else launch_alpha<false, false>(*a, alpha, blocks, stream);
  }
  return (int)cudaGetLastError();
}
