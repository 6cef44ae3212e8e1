// Native BVH builder for the PyTorch port: a copy of
// yuki_tpu/native/bvh_builder.cpp (the port imports nothing of yuki_tpu).
//
// The reference builds its BVH in native Rust (yuki/src/bvh.rs:305-522).
// This is the same algorithm in C++ — recursive top-down build over
// primitive centroids with SAH (12 buckets) / middle / equal-counts splits
// and the reference's equal-counts fallback — exposed through a plain C ABI
// for ctypes.  Any change here must be made to both copies: the port's
// BVH is held field for field against yuki_tpu's (tests/test_torch_bvh.py).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libyuki_bvh.so bvh_builder.cpp
// (done at first use by yuki_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float axis_of(const Vec3& v, int a) {
    return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}
static inline float surface_area(const Vec3& lo, const Vec3& hi) {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return 2.0f * (dx * dy + dz * dy + dx * dz);
}

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kBuckets = 12;

struct Builder {
    const Vec3* lo;
    const Vec3* hi;
    std::vector<Vec3> centroid;
    std::vector<int32_t> order;     // permuted during build
    std::vector<int32_t> ordered;   // final leaf-order prim ids

    // node arrays (SoA out)
    std::vector<Vec3> node_lo, node_hi;
    std::vector<int32_t> prim_offset, prim_count, child0, child1, axis, depth;

    int split_method;  // 0 sah, 1 middle, 2 equal
    int max_shapes;
    int max_leaf;

    int new_node(int d) {
        node_lo.push_back({0, 0, 0});
        node_hi.push_back({0, 0, 0});
        prim_offset.push_back(0);
        prim_count.push_back(0);
        child0.push_back(-1);
        child1.push_back(-1);
        axis.push_back(0);
        depth.push_back(d);
        return (int)node_lo.size() - 1;
    }

    int split_equal(int start, int end, int a) {
        int mid = start + (end - start) / 2;
        std::nth_element(
            order.begin() + start, order.begin() + mid, order.begin() + end,
            [&](int32_t i, int32_t j) {
                return axis_of(centroid[i], a) < axis_of(centroid[j], a);
            });
        return mid;
    }

    int split_middle(int start, int end, int a, float c_lo, float c_hi) {
        float mid_value = 0.5f * (c_lo + c_hi);
        auto it = std::partition(
            order.begin() + start, order.begin() + end,
            [&](int32_t i) { return axis_of(centroid[i], a) < mid_value; });
        return (int)(it - order.begin());
    }

    // Returns split point, or -1 for "SAH says leaf", mirroring
    // split_sah's usize::MAX (bvh.rs:452-522).
    int split_sah(int start, int end, int a, float c_lo, float c_hi,
                  const Vec3& b_lo, const Vec3& b_hi) {
        int count = end - start;
        if (count <= 2) return start;  // caller falls back (bvh.rs:466)
        int counts[kBuckets] = {0};
        Vec3 blo[kBuckets], bhi[kBuckets];
        for (int b = 0; b < kBuckets; ++b) {
            blo[b] = {kInf, kInf, kInf};
            bhi[b] = {-kInf, -kInf, -kInf};
        }
        float inv = 1.0f / (c_hi - c_lo);
        auto bucket_of = [&](int32_t i) {
            float bf = kBuckets * ((axis_of(centroid[i], a) - c_lo) * inv);
            int b = (int)std::max(bf, 0.0f);
            return std::min(b, kBuckets - 1);
        };
        for (int i = start; i < end; ++i) {
            int32_t p = order[i];
            int b = bucket_of(p);
            counts[b]++;
            blo[b] = vmin(blo[b], lo[p]);
            bhi[b] = vmax(bhi[b], hi[p]);
        }
        float total_sa = std::max(surface_area(b_lo, b_hi), 1e-10f);
        float best_cost = kInf;
        int best = 0;
        for (int i = 0; i < kBuckets - 1; ++i) {
            Vec3 l0 = {kInf, kInf, kInf}, h0 = {-kInf, -kInf, -kInf};
            Vec3 l1 = l0, h1 = h0;
            int64_t c0 = 0, c1 = 0;
            for (int b = 0; b <= i; ++b) {
                if (counts[b]) {
                    l0 = vmin(l0, blo[b]);
                    h0 = vmax(h0, bhi[b]);
                    c0 += counts[b];
                }
            }
            for (int b = i + 1; b < kBuckets; ++b) {
                if (counts[b]) {
                    l1 = vmin(l1, blo[b]);
                    h1 = vmax(h1, bhi[b]);
                    c1 += counts[b];
                }
            }
            float sa0 = c0 ? surface_area(l0, h0) : 0.0f;
            float sa1 = c1 ? surface_area(l1, h1) : 0.0f;
            float cost = 1.0f + (c0 * sa0 + c1 * sa1) / total_sa;
            if (cost < best_cost) {
                best_cost = cost;
                best = i;
            }
        }
        if (best_cost < (float)count) {
            auto it = std::partition(
                order.begin() + start, order.begin() + end,
                [&](int32_t i) { return bucket_of(i) <= best; });
            return (int)(it - order.begin());
        }
        return -1;  // leaf
    }

    int build(int start, int end, int d) {
        int node = new_node(d);
        Vec3 b_lo = {kInf, kInf, kInf}, b_hi = {-kInf, -kInf, -kInf};
        for (int i = start; i < end; ++i) {
            b_lo = vmin(b_lo, lo[order[i]]);
            b_hi = vmax(b_hi, hi[order[i]]);
        }
        node_lo[node] = b_lo;
        node_hi[node] = b_hi;
        int count = end - start;

        auto make_leaf = [&]() {
            prim_offset[node] = (int)ordered.size();
            prim_count[node] = count;
            for (int i = start; i < end; ++i) ordered.push_back(order[i]);
            return node;
        };

        if (count <= max_shapes) return make_leaf();

        Vec3 c_lo = {kInf, kInf, kInf}, c_hi = {-kInf, -kInf, -kInf};
        for (int i = start; i < end; ++i) {
            c_lo = vmin(c_lo, centroid[order[i]]);
            c_hi = vmax(c_hi, centroid[order[i]]);
        }
        float dx = c_hi.x - c_lo.x, dy = c_hi.y - c_lo.y, dz = c_hi.z - c_lo.z;
        int a = (dx > dy && dx > dz) ? 0 : (dy > dz ? 1 : 2);
        float ca_lo = axis_of(c_lo, a), ca_hi = axis_of(c_hi, a);

        int mid;
        if (ca_hi == ca_lo) {
            // Degenerate centroids (bvh.rs:345-349): leaf unless too fat
            // for the vector leaf test (divergence documented in bvh.py).
            if (count <= max_leaf) return make_leaf();
            mid = start + count / 2;
        } else if (split_method == 0) {
            mid = split_sah(start, end, a, ca_lo, ca_hi, b_lo, b_hi);
            if (mid < 0) {  // SAH says leaf
                if (count <= max_leaf) return make_leaf();
                mid = -1;
            }
            if (mid == start || mid == end || mid < 0)
                mid = split_equal(start, end, a);
        } else if (split_method == 1) {
            mid = split_middle(start, end, a, ca_lo, ca_hi);
            if (mid == start || mid == end) mid = split_equal(start, end, a);
        } else {
            mid = split_equal(start, end, a);
        }

        axis[node] = a;
        int c0 = build(start, mid, d + 1);
        int c1 = build(mid, end, d + 1);
        child0[node] = c0;
        child1[node] = c1;
        return node;
    }
};

}  // namespace

extern "C" {

// Builds the BVH. Outputs are caller-allocated with capacity 2*n nodes
// (n_out receives the actual node count). Returns 0 on success.
int build_bvh(
    const float* tri_lo,   // [n,3]
    const float* tri_hi,   // [n,3]
    int64_t n,
    int split_method,      // 0 sah, 1 middle, 2 equal_counts
    int max_shapes_in_node,
    int max_leaf_size,
    float* out_node_lo,    // [2n,3]
    float* out_node_hi,    // [2n,3]
    int32_t* out_prim_offset,
    int32_t* out_prim_count,
    int32_t* out_child0,
    int32_t* out_child1,
    int32_t* out_axis,
    int32_t* out_depth,
    int32_t* out_prim_order,  // [n]
    int64_t* n_nodes_out) {
    if (n <= 0) return 1;
    Builder b;
    b.lo = reinterpret_cast<const Vec3*>(tri_lo);
    b.hi = reinterpret_cast<const Vec3*>(tri_hi);
    b.split_method = split_method;
    b.max_shapes = std::max(1, max_shapes_in_node);
    b.max_leaf = std::max(b.max_shapes, max_leaf_size);
    b.centroid.resize(n);
    b.order.resize(n);
    for (int64_t i = 0; i < n; ++i) {
        b.centroid[i] = {
            0.5f * (b.lo[i].x + b.hi[i].x),
            0.5f * (b.lo[i].y + b.hi[i].y),
            0.5f * (b.lo[i].z + b.hi[i].z),
        };
        b.order[i] = (int32_t)i;
    }
    size_t reserve = (size_t)(2 * n);
    b.node_lo.reserve(reserve);
    b.node_hi.reserve(reserve);
    b.ordered.reserve(n);

    b.build(0, (int)n, 0);

    int64_t m = (int64_t)b.node_lo.size();
    if ((size_t)m > reserve) return 2;
    std::memcpy(out_node_lo, b.node_lo.data(), m * sizeof(Vec3));
    std::memcpy(out_node_hi, b.node_hi.data(), m * sizeof(Vec3));
    std::memcpy(out_prim_offset, b.prim_offset.data(), m * sizeof(int32_t));
    std::memcpy(out_prim_count, b.prim_count.data(), m * sizeof(int32_t));
    std::memcpy(out_child0, b.child0.data(), m * sizeof(int32_t));
    std::memcpy(out_child1, b.child1.data(), m * sizeof(int32_t));
    std::memcpy(out_axis, b.axis.data(), m * sizeof(int32_t));
    std::memcpy(out_depth, b.depth.data(), m * sizeof(int32_t));
    std::memcpy(out_prim_order, b.ordered.data(), n * sizeof(int32_t));
    *n_nodes_out = m;
    return 0;
}

}  // extern "C"

extern "C" {

// Octant-threaded link tables (bvh.py _thread_links, 8 DFS orders).
// out_links is [8, m, 2] int32 (hit, miss).
int thread_links(
    const int32_t* child0,
    const int32_t* child1,
    const int32_t* axis,
    const int32_t* prim_count,
    int64_t m,
    int32_t* out_links) {
    std::vector<std::pair<int32_t, int32_t>> stack;
    stack.reserve(64);
    for (int o = 0; o < 8; ++o) {
        int32_t* hit = out_links + (size_t)o * m * 2;
        bool neg[3] = {(o & 1) != 0, (o & 2) != 0, (o & 4) != 0};
        stack.clear();
        stack.push_back({0, -1});
        while (!stack.empty()) {
            auto [node, miss_t] = stack.back();
            stack.pop_back();
            hit[node * 2 + 1] = miss_t;
            if (prim_count[node] > 0) {
                hit[node * 2 + 0] = miss_t;
            } else {
                int32_t c0 = child0[node], c1 = child1[node];
                int32_t near = neg[axis[node]] ? c1 : c0;
                int32_t far = neg[axis[node]] ? c0 : c1;
                hit[node * 2 + 0] = near;
                stack.push_back({far, miss_t});
                stack.push_back({near, far});
            }
        }
    }
    return 0;
}

}  // extern "C"
