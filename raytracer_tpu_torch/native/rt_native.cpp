// rt_native: the host-side native builders and loader of raytracer_tpu_torch.
//
//   - the cluster table: a binned-SAH binary build (leaf size C) over a
//     triangle subset, cut into clusters whose padded SoA Moller-Trumbore
//     basis is packed in one pass (the reference's TriCache4 bundle build,
//     src/BVH.cpp:577-623, widened 4 -> C lanes; the SAH split follows
//     src/BVH.cpp:625-1106);
//   - one BLAS of the wide BVH (geometry/bvh.py): the same binary build,
//     collapsed to B-wide nodes by expanding the largest-area internal slot
//     (the reference's QBVH_Node::build, src/BVH.cpp:100-389);
//   - the two-pass OBJ parser (reference: src/TriangleMeshLoad.cpp:49-214).
//
// Exposed as a C ABI for ctypes (native/__init__.py), built with g++ at
// first use. The arithmetic is the JAX package's native builder's, line for
// line, so the tables and arrays are byte-equal to its own.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int NUM_BINS = 8;  // reference: src/Miro.h:67

struct V3 {
    float x, y, z;
    V3() : x(0), y(0), z(0) {}
    V3(float a, float b, float c) : x(a), y(b), z(c) {}
};

static inline V3 vmin(const V3& a, const V3& b) {
    return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline V3 vmax(const V3& a, const V3& b) {
    return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}
static inline float harea(const V3& lo, const V3& hi) {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
}

struct BinNode {
    V3 lo, hi;
    int64_t left = -1, right = -1;  // children
    int64_t start = -1, count = 0;  // leaf range
};

struct Builder {
    const float* bmin;
    const float* bmax;
    std::vector<V3> cent;
    std::vector<int64_t> order;
    std::vector<BinNode> nodes;
    int leaf_size;

    V3 pmin(int64_t i) const { return V3(bmin[3 * i], bmin[3 * i + 1], bmin[3 * i + 2]); }
    V3 pmax(int64_t i) const { return V3(bmax[3 * i], bmax[3 * i + 1], bmax[3 * i + 2]); }

    int64_t build(int64_t lo, int64_t hi) {
        int64_t me = (int64_t)nodes.size();
        nodes.emplace_back();
        V3 blo(FLT_MAX, FLT_MAX, FLT_MAX), bhi(-FLT_MAX, -FLT_MAX, -FLT_MAX);
        V3 clo(FLT_MAX, FLT_MAX, FLT_MAX), chi(-FLT_MAX, -FLT_MAX, -FLT_MAX);
        for (int64_t k = lo; k < hi; ++k) {
            int64_t id = order[k];
            blo = vmin(blo, pmin(id));
            bhi = vmax(bhi, pmax(id));
            clo = vmin(clo, cent[id]);
            chi = vmax(chi, cent[id]);
        }
        nodes[me].lo = blo;
        nodes[me].hi = bhi;
        int64_t cnt = hi - lo;
        if (cnt <= leaf_size) {
            nodes[me].start = lo;
            nodes[me].count = cnt;
            return me;
        }
        // binned SAH over the 3 axes (reference: src/BVH.cpp:691-793)
        float best_cost = FLT_MAX;
        int best_axis = -1, best_bin = -1;
        for (int axis = 0; axis < 3; ++axis) {
            float cmin = axis == 0 ? clo.x : (axis == 1 ? clo.y : clo.z);
            float cmaxv = axis == 0 ? chi.x : (axis == 1 ? chi.y : chi.z);
            float ext = cmaxv - cmin;
            if (ext <= 1e-12f) continue;
            float scale = NUM_BINS * (1.0f - 1e-6f) / ext;
            int64_t counts[NUM_BINS] = {0};
            V3 blos[NUM_BINS], bhis[NUM_BINS];
            for (int b = 0; b < NUM_BINS; ++b) {
                blos[b] = V3(FLT_MAX, FLT_MAX, FLT_MAX);
                bhis[b] = V3(-FLT_MAX, -FLT_MAX, -FLT_MAX);
            }
            for (int64_t k = lo; k < hi; ++k) {
                int64_t id = order[k];
                float c = axis == 0 ? cent[id].x : (axis == 1 ? cent[id].y : cent[id].z);
                int b = std::min((int)((c - cmin) * scale), NUM_BINS - 1);
                counts[b]++;
                blos[b] = vmin(blos[b], pmin(id));
                bhis[b] = vmax(bhis[b], pmax(id));
            }
            // left sweep
            float larea[NUM_BINS];
            int64_t lcnt[NUM_BINS];
            V3 alo = blos[0], ahi = bhis[0];
            int64_t acc = 0;
            for (int b = 0; b < NUM_BINS; ++b) {
                alo = vmin(alo, blos[b]);
                ahi = vmax(ahi, bhis[b]);
                acc += counts[b];
                larea[b] = harea(alo, ahi);
                lcnt[b] = acc;
            }
            // right sweep + cost
            alo = blos[NUM_BINS - 1];
            ahi = bhis[NUM_BINS - 1];
            acc = 0;
            for (int b = NUM_BINS - 1; b >= 1; --b) {
                alo = vmin(alo, blos[b]);
                ahi = vmax(ahi, bhis[b]);
                acc += counts[b];
                int64_t nl = lcnt[b - 1], nr = acc;
                if (nl == 0 || nr == 0) continue;
                float cost = larea[b - 1] * nl + harea(alo, ahi) * nr;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b - 1;
                }
            }
        }
        int64_t mid;
        if (best_axis < 0) {
            mid = lo + cnt / 2;  // degenerate: median split
        } else {
            float cmin = best_axis == 0 ? clo.x : (best_axis == 1 ? clo.y : clo.z);
            float cmaxv = best_axis == 0 ? chi.x : (best_axis == 1 ? chi.y : chi.z);
            float scale = NUM_BINS * (1.0f - 1e-6f) / (cmaxv - cmin);
            auto* beg = order.data() + lo;
            auto* end = order.data() + hi;
            auto* it = std::partition(beg, end, [&](int64_t id) {
                float c = best_axis == 0 ? cent[id].x
                        : (best_axis == 1 ? cent[id].y : cent[id].z);
                return (int)std::min((int)((c - cmin) * scale), NUM_BINS - 1)
                       <= best_bin;
            });
            mid = lo + (it - beg);
            if (mid == lo || mid == hi) mid = lo + cnt / 2;
        }
        int64_t l = build(lo, mid);
        int64_t r = build(mid, hi);
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

struct WideEmitter {
    const std::vector<BinNode>& bn;
    int B;
    float* node_min;
    float* node_max;
    int32_t* child;
    int32_t* count;
    int64_t cap;
    int64_t n_out = 0;
    int64_t prim_off;
    int node_base;
    int max_depth = 0;

    float area(int64_t i) const { return harea(bn[i].lo, bn[i].hi); }

    int64_t emit(int64_t b, int depth) {
        if (n_out >= cap) return -1;
        int64_t me = n_out++;
        if (depth + 1 > max_depth) max_depth = depth + 1;
        // collect up to B slots, expanding largest-area internal nodes
        std::vector<int64_t> slots{b};
        while ((int)slots.size() < B) {
            int pick = -1;
            float best = -1.f;
            for (int k = 0; k < (int)slots.size(); ++k) {
                if (bn[slots[k]].left >= 0 && area(slots[k]) > best) {
                    best = area(slots[k]);
                    pick = k;
                }
            }
            if (pick < 0) break;
            int64_t s = slots[pick];
            slots.erase(slots.begin() + pick);
            slots.push_back(bn[s].left);
            slots.push_back(bn[s].right);
        }
        // init empty
        for (int c = 0; c < B; ++c) {
            for (int a = 0; a < 3; ++a) {
                node_min[(me * B + c) * 3 + a] = FLT_MAX;
                node_max[(me * B + c) * 3 + a] = -FLT_MAX;
            }
            child[me * B + c] = -1;
            count[me * B + c] = -1;
        }
        for (int c = 0; c < (int)slots.size(); ++c) {
            int64_t s = slots[c];
            node_min[(me * B + c) * 3 + 0] = bn[s].lo.x;
            node_min[(me * B + c) * 3 + 1] = bn[s].lo.y;
            node_min[(me * B + c) * 3 + 2] = bn[s].lo.z;
            node_max[(me * B + c) * 3 + 0] = bn[s].hi.x;
            node_max[(me * B + c) * 3 + 1] = bn[s].hi.y;
            node_max[(me * B + c) * 3 + 2] = bn[s].hi.z;
            if (bn[s].left < 0) {
                child[me * B + c] = (int32_t)(prim_off + bn[s].start);
                count[me * B + c] = (int32_t)bn[s].count;
            } else {
                int64_t cid = emit(s, depth + 1);
                if (cid < 0) return -1;
                child[me * B + c] = (int32_t)(node_base + cid);
                count[me * B + c] = 0;
            }
        }
        return me;
    }
};

}  // namespace

extern "C" {

// Build one BLAS subtree. Returns the number of wide nodes emitted (root is
// the first), or -1 on capacity overflow. order_out receives the permutation
// of [0, n) such that leaves cover contiguous ranges. prim_off/node_base
// offset leaf starts / child ids for pool merging. out_depth: subtree depth.
int64_t rt_build_bvh(const float* bmin, const float* bmax, int64_t n,
                     int leaf_size, int branch, int64_t prim_off,
                     int64_t node_base, float* node_min, float* node_max,
                     int32_t* child, int32_t* count, int64_t* order_out,
                     int64_t cap, int32_t* out_depth) {
    Builder bld;
    bld.bmin = bmin;
    bld.bmax = bmax;
    bld.leaf_size = leaf_size;
    bld.cent.resize(n);
    bld.order.resize(n);
    for (int64_t i = 0; i < n; ++i) {
        bld.cent[i] = V3(0.5f * (bmin[3 * i] + bmax[3 * i]),
                         0.5f * (bmin[3 * i + 1] + bmax[3 * i + 1]),
                         0.5f * (bmin[3 * i + 2] + bmax[3 * i + 2]));
        bld.order[i] = i;
    }
    bld.nodes.reserve(2 * n + 2);
    bld.build(0, n);

    WideEmitter we{bld.nodes, branch, node_min, node_max, child, count,
                   cap, 0, prim_off, (int)node_base};
    int64_t root = we.emit(0, 0);
    if (root < 0) return -1;
    std::memcpy(order_out, bld.order.data(), n * sizeof(int64_t));
    *out_depth = we.max_depth;
    return we.n_out;
}

// ---------------------------------------------------------------------------
// OBJ parsing (two-pass, reference: src/TriangleMeshLoad.cpp:49-214)
// ---------------------------------------------------------------------------

// Pass 1: count records. counts = {nv, nvt, nvn, ntris, has_t, has_n}
int rt_obj_count(const char* path, int64_t* counts) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[4096];
    int64_t nv = 0, nvt = 0, nvn = 0, ntri = 0;
    int64_t has_t = 0, has_n = 0;
    while (fgets(line, sizeof line, f)) {
        if (line[0] == 'v') {
            if (line[1] == ' ' || line[1] == '\t') nv++;
            else if (line[1] == 't') nvt++;
            else if (line[1] == 'n') nvn++;
        } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
            // count corners for fan triangulation; detect formats
            int corners = 0;
            char* p = line + 1;
            while (*p) {
                while (*p == ' ' || *p == '\t') p++;
                if (*p == '\0' || *p == '\n' || *p == '\r') break;
                corners++;
                const char* tok = p;
                int slashes = 0;
                bool tpresent = false;
                while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') {
                    if (*p == '/') {
                        slashes++;
                        if (slashes == 1 && p[1] != '/' && p[1] != ' ') tpresent = true;
                    }
                    p++;
                }
                if (slashes >= 1 && tpresent) has_t = 1;
                if (slashes == 2) has_n = 1;
                (void)tok;
            }
            if (corners >= 3) ntri += corners - 2;
        }
    }
    fclose(f);
    counts[0] = nv; counts[1] = nvt; counts[2] = nvn;
    counts[3] = ntri; counts[4] = has_t; counts[5] = has_n;
    return 0;
}

static inline int64_t fix_idx(long idx, int64_t n) {
    return idx > 0 ? idx - 1 : n + idx;
}

// Pass 2: fill arrays. fv/ft/fn are ntris*3 int32 (ft/fn filled with -1 when
// a corner lacks the record).
int rt_obj_fill(const char* path, float* v, float* vt, float* vn,
                int32_t* fv, int32_t* ft, int32_t* fn_) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[4096];
    int64_t iv = 0, ivt = 0, ivn = 0, itri = 0;
    int64_t nv = 0, nvt = 0, nvn = 0;
    while (fgets(line, sizeof line, f)) {
        if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
            sscanf(line + 1, "%f %f %f", &v[3 * iv], &v[3 * iv + 1], &v[3 * iv + 2]);
            iv++; nv++;
        } else if (line[0] == 'v' && line[1] == 't') {
            sscanf(line + 2, "%f %f", &vt[2 * ivt], &vt[2 * ivt + 1]);
            ivt++; nvt++;
        } else if (line[0] == 'v' && line[1] == 'n') {
            sscanf(line + 2, "%f %f %f", &vn[3 * ivn], &vn[3 * ivn + 1], &vn[3 * ivn + 2]);
            ivn++; nvn++;
        } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
            long vi[64], ti[64], ni[64];
            int corners = 0;
            char* p = line + 1;
            while (*p && corners < 64) {
                while (*p == ' ' || *p == '\t') p++;
                if (*p == '\0' || *p == '\n' || *p == '\r') break;
                long a = strtol(p, &p, 10);
                long b = 0, c = 0;
                bool hb = false, hc = false;
                if (*p == '/') {
                    p++;
                    if (*p != '/') { b = strtol(p, &p, 10); hb = true; }
                    if (*p == '/') { p++; c = strtol(p, &p, 10); hc = true; }
                }
                vi[corners] = fix_idx(a, nv);
                ti[corners] = hb ? fix_idx(b, nvt) : -1;
                ni[corners] = hc ? fix_idx(c, nvn) : -1;
                corners++;
            }
            for (int k = 1; k + 1 < corners; ++k) {
                fv[3 * itri] = (int32_t)vi[0];
                fv[3 * itri + 1] = (int32_t)vi[k];
                fv[3 * itri + 2] = (int32_t)vi[k + 1];
                ft[3 * itri] = (int32_t)ti[0];
                ft[3 * itri + 1] = (int32_t)ti[k];
                ft[3 * itri + 2] = (int32_t)ti[k + 1];
                fn_[3 * itri] = (int32_t)ni[0];
                fn_[3 * itri + 1] = (int32_t)ni[k];
                fn_[3 * itri + 2] = (int32_t)ni[k + 1];
                itri++;
            }
        }
    }
    fclose(f);
    return 0;
}

// Build the block-coherent cluster table (geometry/clusters.py) natively:
// binned-SAH binary build with leaf size C over a triangle SUBSET, then the
// padded SoA Moller-Trumbore basis packed per cluster in one pass. The
// TPU analogue of the reference's TriCache4 bundle build
// (src/BVH.cpp:577-623), widened 4 -> C lanes.
//   verts/verts_t1: (V, 3) f32 (equal pointers for static geometry)
//   faces: (T, 3) i32; tri_ids: (N,) i64 global ids of the subset
//   outputs sized for max_clusters rows: bb_min/bb_max (M, 3),
//   p0/e1/e2[/q0/q1/q2 when has_mb] (M, 3, C), tri_out (M, C)
// Returns the cluster count M, or -1 on capacity overflow.
int64_t rt_build_clusters(const float* verts, const float* verts_t1,
                          const int32_t* faces, const int64_t* tri_ids,
                          int64_t n, int32_t C, int32_t has_mb,
                          int64_t max_clusters,
                          float* bb_min, float* bb_max,
                          float* p0, float* e1, float* e2,
                          float* q0, float* q1, float* q2,
                          int32_t* tri_out) {
    if (n <= 0) return 0;
    // per-subset-triangle AABBs (union of both motion poses, reference
    // MBObject::getAABB)
    std::vector<float> bmin(3 * n), bmax(3 * n);
    for (int64_t k = 0; k < n; ++k) {
        int64_t t = tri_ids[k];
        V3 lo(FLT_MAX, FLT_MAX, FLT_MAX), hi(-FLT_MAX, -FLT_MAX, -FLT_MAX);
        for (int c = 0; c < 3; ++c) {
            int32_t vi = faces[3 * t + c];
            for (const float* vv : {verts, verts_t1}) {
                V3 p(vv[3 * vi], vv[3 * vi + 1], vv[3 * vi + 2]);
                lo = vmin(lo, p);
                hi = vmax(hi, p);
            }
        }
        bmin[3 * k] = lo.x; bmin[3 * k + 1] = lo.y; bmin[3 * k + 2] = lo.z;
        bmax[3 * k] = hi.x; bmax[3 * k + 1] = hi.y; bmax[3 * k + 2] = hi.z;
    }

    Builder bld;
    bld.bmin = bmin.data();
    bld.bmax = bmax.data();
    bld.leaf_size = C;
    bld.cent.resize(n);
    bld.order.resize(n);
    for (int64_t i = 0; i < n; ++i) {
        bld.cent[i] = V3(0.5f * (bmin[3 * i] + bmax[3 * i]),
                         0.5f * (bmin[3 * i + 1] + bmax[3 * i + 1]),
                         0.5f * (bmin[3 * i + 2] + bmax[3 * i + 2]));
        bld.order[i] = i;
    }
    bld.nodes.reserve(2 * n + 2);
    bld.build(0, n);

    int64_t m = 0;
    for (int64_t ni = 0; ni < (int64_t)bld.nodes.size(); ++ni) {
        const BinNode& nd = bld.nodes[ni];
        if (nd.left >= 0) continue;  // internal
        if (m >= max_clusters) return -1;
        // cluster AABB
        bb_min[3 * m] = nd.lo.x; bb_min[3 * m + 1] = nd.lo.y;
        bb_min[3 * m + 2] = nd.lo.z;
        bb_max[3 * m] = nd.hi.x; bb_max[3 * m + 1] = nd.hi.y;
        bb_max[3 * m + 2] = nd.hi.z;
        // lanes: tri ids + MT basis in SoA [component][lane]
        for (int32_t lane = 0; lane < C; ++lane) {
            bool pad = lane >= nd.count;
            int64_t gid = pad ? -1 : tri_ids[bld.order[nd.start + lane]];
            tri_out[m * C + lane] = (int32_t)gid;
            for (int comp = 0; comp < 3; ++comp) {
                int64_t at = (m * 3 + comp) * C + lane;
                if (pad) {
                    p0[at] = e1[at] = e2[at] = 0.f;  // det==0: rejected
                    if (has_mb) q0[at] = q1[at] = q2[at] = 0.f;
                    continue;
                }
                int32_t a = faces[3 * gid], b = faces[3 * gid + 1],
                        c = faces[3 * gid + 2];
                float pa = verts[3 * a + comp];
                p0[at] = pa;
                e1[at] = verts[3 * b + comp] - pa;
                e2[at] = verts[3 * c + comp] - pa;
                if (has_mb) {
                    float qa = verts_t1[3 * a + comp];
                    q0[at] = qa;
                    q1[at] = verts_t1[3 * b + comp] - qa;
                    q2[at] = verts_t1[3 * c + comp] - qa;
                }
            }
        }
        ++m;
    }
    return m;
}

}  // extern "C"
