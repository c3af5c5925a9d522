// Native BVH builder (C++17, no dependencies).
//
// Plays the role of the reference's in-repo C++ builders
// (reference: core/fast_bvh_builder.h binned SAH, core/sbvh_builder.h
// spatial splits) for this renderer: the Python/NumPy builder is the
// portable fallback; this one is the fast path for large scenes.
//
// Algorithm: top-down binned SAH. All three axes are binned (32 bins)
// per node, the cheapest split wins, SAH leaf termination against a
// traversal cost, median fallback for degenerate distributions. Output is
// the same implicit-DFS binary layout the Python builder emits
// (left child = i+1, right[i] explicit, leaves right[i] == -1), so the
// threading/flattening pass is shared.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libbvh.so bvh_builder.cpp

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NUM_BINS = 32;

struct Vec3 {
    float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct BBox {
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};

    void extend(const BBox& b) {
        lo = vmin(lo, b.lo);
        hi = vmax(hi, b.hi);
    }
    void extend(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float half_area() const {
        const float dx = std::max(hi.x - lo.x, 0.f);
        const float dy = std::max(hi.y - lo.y, 0.f);
        const float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const BBox* boxes;
    const Vec3* centers;
    int leaf_size;
    float traversal_cost;

    std::vector<int> prim_ids;
    // node arrays (DFS order)
    std::vector<float> node_min, node_max;
    std::vector<int> right, start, count;

    int emit_node(const BBox& b) {
        node_min.insert(node_min.end(), {b.lo.x, b.lo.y, b.lo.z});
        node_max.insert(node_max.end(), {b.hi.x, b.hi.y, b.hi.z});
        right.push_back(-1);
        start.push_back(0);
        count.push_back(0);
        return static_cast<int>(right.size()) - 1;
    }

    // Build range [lo, hi) of prim_ids; returns node index.
    int build_range(int lo, int hi) {
        BBox bb;
        for (int i = lo; i < hi; ++i) bb.extend(boxes[prim_ids[i]]);
        const int node = emit_node(bb);
        const int n = hi - lo;

        if (n <= leaf_size) {
            make_leaf(node, lo, n);
            return node;
        }

        // Centroid bounds.
        BBox cb;
        for (int i = lo; i < hi; ++i) cb.extend(centers[prim_ids[i]]);

        int best_axis = -1, best_bin = -1;
        float best_cost = FLT_MAX;
        float best_origin = 0.f, best_scale = 0.f;

        for (int axis = 0; axis < 3; ++axis) {
            const float origin = (&cb.lo.x)[axis];
            const float extent = (&cb.hi.x)[axis] - origin;
            if (extent <= 1e-12f) continue;
            const float scale = NUM_BINS * (1.0f - 1e-6f) / extent;

            BBox bin_bb[NUM_BINS];
            int bin_n[NUM_BINS] = {0};
            for (int i = lo; i < hi; ++i) {
                const int id = prim_ids[i];
                int b = static_cast<int>(((&centers[id].x)[axis] - origin) * scale);
                b = std::min(std::max(b, 0), NUM_BINS - 1);
                bin_bb[b].extend(boxes[id]);
                bin_n[b]++;
            }

            // Right-to-left sweep.
            float right_area[NUM_BINS];
            BBox acc;
            int nr = 0;
            int right_n[NUM_BINS];
            for (int b = NUM_BINS - 1; b > 0; --b) {
                acc.extend(bin_bb[b]);
                nr += bin_n[b];
                right_area[b] = acc.half_area();
                right_n[b] = nr;
            }
            // Left-to-right sweep + cost.
            BBox accl;
            int nl = 0;
            for (int b = 0; b < NUM_BINS - 1; ++b) {
                accl.extend(bin_bb[b]);
                nl += bin_n[b];
                if (nl == 0 || right_n[b + 1] == 0) continue;
                const float cost =
                    accl.half_area() * nl + right_area[b + 1] * right_n[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                    best_origin = origin;
                    best_scale = scale;
                }
            }
        }

        int mid;
        if (best_axis < 0) {
            // Degenerate centroids: median split on an arbitrary order.
            mid = lo + n / 2;
        } else {
            // SAH leaf termination (same rule as the Python builder).
            const float parent_area = std::max(bb.half_area(), 1e-20f);
            if (n <= 2 * leaf_size &&
                best_cost / parent_area + traversal_cost >= static_cast<float>(n)) {
                // Splitting is not profitable but leaves must stay small:
                // only stop if it fits a leaf.
                if (n <= leaf_size) {
                    make_leaf(node, lo, n);
                    return node;
                }
            }
            auto pred = [&](int id) {
                int b = static_cast<int>(
                    ((&centers[id].x)[best_axis] - best_origin) * best_scale);
                b = std::min(std::max(b, 0), NUM_BINS - 1);
                return b <= best_bin;
            };
            int* first = prim_ids.data() + lo;
            int* last = prim_ids.data() + hi;
            int* pivot = std::partition(first, last, pred);
            mid = lo + static_cast<int>(pivot - first);
            if (mid == lo || mid == hi) mid = lo + n / 2;
        }

        build_range(lo, mid);            // left child = node + 1 (DFS)
        right[node] = build_range(mid, hi);
        return node;
    }

    void make_leaf(int node, int lo, int n) {
        right[node] = -1;
        start[node] = lo;
        count[node] = n;
    }
};

// ---------------------------------------------------------------------
// Spatial-split builder (SBVH, Stich et al. 2009) — the reference's
// core/sbvh_builder.h role. References (tri id + chopped bbox) are
// duplicated across children when a spatial split is cheaper than the
// best object split and the node's object-split children overlap.
// Chopped bounds use the exact candidate identity: vertices inside the
// slab plus edge/plane intersections. Duplication is capped by a global
// reference budget; reference unsplitting is not implemented (the
// budget bounds growth instead).
// ---------------------------------------------------------------------

struct Ref {
    int tri;
    BBox box;
};

struct SBuilder {
    const Vec3* verts;      // 3 per triangle
    int leaf_size;
    float root_area;
    float alpha;
    long budget;            // remaining extra references
    std::vector<float> node_min, node_max;
    std::vector<int> right, start, count;
    std::vector<int> out_prims;

    int emit_node(const BBox& b) {
        node_min.insert(node_min.end(), {b.lo.x, b.lo.y, b.lo.z});
        node_max.insert(node_max.end(), {b.hi.x, b.hi.y, b.hi.z});
        right.push_back(-1);
        start.push_back(0);
        count.push_back(0);
        return static_cast<int>(right.size()) - 1;
    }

    // Bounds of triangle `tri` clipped to [x0, x1] on `axis`, then
    // intersected with the (possibly pre-chopped) reference box.
    BBox chop(const Ref& r, int axis, float x0, float x1) const {
        BBox out;
        const Vec3* v = verts + 3 * r.tri;
        for (int j = 0; j < 3; ++j) {
            const float x = (&v[j].x)[axis];
            if (x >= x0 && x <= x1) out.extend(v[j]);
            const Vec3& a = v[j];
            const Vec3& b = v[(j + 1) % 3];
            const float ax = (&a.x)[axis], bx = (&b.x)[axis];
            const float den = bx - ax;
            if (std::fabs(den) < 1e-30f) continue;
            for (float plane : {x0, x1}) {
                const float t = (plane - ax) / den;
                if (t >= 0.f && t <= 1.f) {
                    const Vec3 p{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
                                 a.z + t * (b.z - a.z)};
                    out.extend(p);
                }
            }
        }
        // clamp to the slab on the split axis and to the parent ref box
        (&out.lo.x)[axis] = std::max((&out.lo.x)[axis], x0);
        (&out.hi.x)[axis] = std::min((&out.hi.x)[axis], x1);
        out.lo = vmax(out.lo, r.box.lo);
        out.hi = vmin(out.hi, r.box.hi);
        return out;
    }

    // Deferred subtree: refs to build + the right[] slot to patch with
    // the subtree's root (-1 = left child, implicit preorder position).
    struct Work {
        std::vector<Ref> refs;
        int patch;
    };

    // Explicit-stack DFS driver (same discipline as the NumPy builder,
    // accel/sbvh.py): recursion depth equalled tree depth, and SAH /
    // spatial splits can peel leaf-sized slivers — O(n / leaf_size)
    // frames on degenerate input overflows the thread stack.  Pushing
    // {right, left} and popping LIFO reproduces the recursive preorder
    // emission exactly (left child == node + 1).
    int build(std::vector<Ref>& root_refs) {
        std::vector<Work> work;
        work.push_back({std::move(root_refs), -1});
        int root = -1;
        while (!work.empty()) {
            Work w = std::move(work.back());
            work.pop_back();
            const int node = step(w.refs, work);
            if (w.patch >= 0) right[w.patch] = node;
            if (root < 0) root = node;
        }
        return root;
    }

    // One split step: emits `node` for refs and either makes a leaf or
    // pushes the two children onto `work` (right first, so left pops
    // next and lands at node + 1).
    int step(std::vector<Ref>& refs, std::vector<Work>& work) {
        BBox bb;
        for (const Ref& r : refs) bb.extend(r.box);
        const int node = emit_node(bb);
        const int n = static_cast<int>(refs.size());
        if (n <= leaf_size) {
            make_leaf(node, refs);
            return node;
        }

        // ---- object split (binned SAH over reference centroids) ----
        BBox cb;
        for (const Ref& r : refs) {
            const Vec3 c{0.5f * (r.box.lo.x + r.box.hi.x),
                         0.5f * (r.box.lo.y + r.box.hi.y),
                         0.5f * (r.box.lo.z + r.box.hi.z)};
            cb.extend(c);
        }
        int bo_axis = -1, bo_bin = -1;
        float bo_cost = FLT_MAX, bo_origin = 0.f, bo_scale = 0.f;
        float overlap = 0.f;
        for (int axis = 0; axis < 3; ++axis) {
            const float origin = (&cb.lo.x)[axis];
            const float extent = (&cb.hi.x)[axis] - origin;
            if (extent <= 1e-12f) continue;
            const float scale = NUM_BINS * (1.0f - 1e-6f) / extent;
            BBox bin_bb[NUM_BINS];
            int bin_n[NUM_BINS] = {0};
            for (const Ref& r : refs) {
                const float c = 0.5f * ((&r.box.lo.x)[axis] + (&r.box.hi.x)[axis]);
                int b = static_cast<int>((c - origin) * scale);
                b = std::min(std::max(b, 0), NUM_BINS - 1);
                bin_bb[b].extend(r.box);
                bin_n[b]++;
            }
            BBox racc[NUM_BINS];
            int rn[NUM_BINS];
            BBox acc;
            int nr = 0;
            for (int b = NUM_BINS - 1; b > 0; --b) {
                acc.extend(bin_bb[b]);
                nr += bin_n[b];
                racc[b] = acc;
                rn[b] = nr;
            }
            BBox accl;
            int nl = 0;
            for (int b = 0; b < NUM_BINS - 1; ++b) {
                accl.extend(bin_bb[b]);
                nl += bin_n[b];
                if (nl == 0 || rn[b + 1] == 0) continue;
                const float cost =
                    accl.half_area() * nl + racc[b + 1].half_area() * rn[b + 1];
                if (cost < bo_cost) {
                    bo_cost = cost;
                    bo_axis = axis;
                    bo_bin = b;
                    bo_origin = origin;
                    bo_scale = scale;
                    BBox ov;
                    ov.lo = vmax(accl.lo, racc[b + 1].lo);
                    ov.hi = vmin(accl.hi, racc[b + 1].hi);
                    overlap = (ov.hi.x > ov.lo.x && ov.hi.y > ov.lo.y &&
                               ov.hi.z > ov.lo.z)
                                  ? ov.half_area()
                                  : 0.f;
                }
            }
        }

        // ---- spatial split (only when object children overlap) ----
        int bs_axis = -1, bs_bin = -1;
        float bs_cost = FLT_MAX, bs_lo = 0.f, bs_width = 0.f;
        if (bo_axis >= 0 && overlap / root_area > alpha && budget > 0) {
            for (int axis = 0; axis < 3; ++axis) {
                const float lo_a = (&bb.lo.x)[axis];
                const float ext = (&bb.hi.x)[axis] - lo_a;
                if (ext <= 1e-9f) continue;
                const float width = ext / NUM_BINS;
                BBox bin_bb[NUM_BINS];
                int entry[NUM_BINS] = {0}, exit_[NUM_BINS] = {0};
                for (const Ref& r : refs) {
                    int b0 = static_cast<int>(((&r.box.lo.x)[axis] - lo_a) / width);
                    int b1 = static_cast<int>(((&r.box.hi.x)[axis] - lo_a) / width);
                    b0 = std::min(std::max(b0, 0), NUM_BINS - 1);
                    b1 = std::min(std::max(b1, 0), NUM_BINS - 1);
                    entry[b0]++;
                    exit_[b1]++;
                    if (b0 == b1) {
                        bin_bb[b0].extend(r.box);
                    } else {
                        for (int b = b0; b <= b1; ++b) {
                            bin_bb[b].extend(chop(
                                r, axis, lo_a + width * b,
                                lo_a + width * (b + 1)));
                        }
                    }
                }
                BBox racc[NUM_BINS];
                int rn[NUM_BINS];
                BBox acc;
                int nr = 0;
                for (int b = NUM_BINS - 1; b > 0; --b) {
                    acc.extend(bin_bb[b]);
                    nr += exit_[b];
                    racc[b] = acc;
                    rn[b] = nr;
                }
                BBox accl;
                int nl = 0;
                for (int b = 0; b < NUM_BINS - 1; ++b) {
                    accl.extend(bin_bb[b]);
                    nl += entry[b];
                    if (nl == 0 || rn[b + 1] == 0) continue;
                    const float cost = accl.half_area() * nl +
                                       racc[b + 1].half_area() * rn[b + 1];
                    if (cost < bs_cost) {
                        bs_cost = cost;
                        bs_axis = axis;
                        bs_bin = b;
                        bs_lo = lo_a;
                        bs_width = width;
                    }
                }
            }
        }

        std::vector<Ref> left, right_refs;
        if (bs_axis >= 0 && bs_cost < bo_cost) {
            const float plane = bs_lo + bs_width * (bs_bin + 1);
            long nl = 0, nr = 0, dup = 0;
            for (const Ref& r : refs) {
                if ((&r.box.hi.x)[bs_axis] <= plane) nl++;
                else if ((&r.box.lo.x)[bs_axis] >= plane) nr++;
                else dup++;
            }
            // Termination: duplicating splits consume the budget; pure
            // partitions must be strict subsets (same rule as the NumPy
            // builder, accel/sbvh.py).
            const bool usable =
                dup <= budget && nl + dup > 0 && nr + dup > 0 &&
                (dup > 0 || (nl + dup < n && nr + dup < n));
            if (usable) {
                budget -= dup;
                left.reserve(nl + dup);
                right_refs.reserve(nr + dup);
                for (const Ref& r : refs) {
                    const float rlo = (&r.box.lo.x)[bs_axis];
                    const float rhi = (&r.box.hi.x)[bs_axis];
                    if (rhi <= plane) left.push_back(r);
                    else if (rlo >= plane) right_refs.push_back(r);
                    else {
                        left.push_back({r.tri, chop(r, bs_axis, rlo, plane)});
                        right_refs.push_back(
                            {r.tri, chop(r, bs_axis, plane, rhi)});
                    }
                }
                refs.clear();
                refs.shrink_to_fit();
                work.push_back({std::move(right_refs), node});
                work.push_back({std::move(left), -1});
                return node;
            }
        }

        // object split (or median fallback)
        if (bo_axis < 0) {
            std::vector<Ref> sorted = refs;
            const int axis = [&] {
                const float ex = bb.hi.x - bb.lo.x, ey = bb.hi.y - bb.lo.y,
                            ez = bb.hi.z - bb.lo.z;
                return ex > ey ? (ex > ez ? 0 : 2) : (ey > ez ? 1 : 2);
            }();
            std::sort(sorted.begin(), sorted.end(), [&](const Ref& a, const Ref& b) {
                return (&a.box.lo.x)[axis] < (&b.box.lo.x)[axis];
            });
            const size_t mid = sorted.size() / 2;
            left.assign(sorted.begin(), sorted.begin() + mid);
            right_refs.assign(sorted.begin() + mid, sorted.end());
        } else {
            for (const Ref& r : refs) {
                const float c =
                    0.5f * ((&r.box.lo.x)[bo_axis] + (&r.box.hi.x)[bo_axis]);
                int b = static_cast<int>((c - bo_origin) * bo_scale);
                b = std::min(std::max(b, 0), NUM_BINS - 1);
                if (b <= bo_bin) left.push_back(r);
                else right_refs.push_back(r);
            }
            if (left.empty() || right_refs.empty()) {
                std::vector<Ref> all = refs;
                left.clear();
                right_refs.clear();
                const size_t mid = all.size() / 2;
                left.assign(all.begin(), all.begin() + mid);
                right_refs.assign(all.begin() + mid, all.end());
            }
        }
        refs.clear();
        refs.shrink_to_fit();
        work.push_back({std::move(right_refs), node});
        work.push_back({std::move(left), -1});
        return node;
    }

    void make_leaf(int node, const std::vector<Ref>& refs) {
        right[node] = -1;
        start[node] = static_cast<int>(out_prims.size());
        count[node] = static_cast<int>(refs.size());
        for (const Ref& r : refs) out_prims.push_back(r.tri);
    }
};

}  // namespace

extern "C" {

// Spatial-split build. `tri_verts` is 9 floats per triangle. Output node
// arrays must hold >= 4 * num_tris entries; out_prim_ids must hold
// >= ceil(num_tris * ref_budget) + 16. Returns the node count and writes
// the emitted reference count to *out_num_refs, or -1 on error/overflow.
int imba_build_sbvh(const float* tri_verts, int num_tris, int leaf_size,
                    float alpha, float ref_budget, float* out_node_min,
                    float* out_node_max, int* out_right, int* out_start,
                    int* out_count, int* out_prim_ids, int* out_num_refs) {
    if (num_tris <= 0) return -1;
    std::vector<Vec3> verts(3 * static_cast<size_t>(num_tris));
    std::memcpy(verts.data(), tri_verts, sizeof(float) * 9 * num_tris);

    std::vector<Ref> refs(num_tris);
    BBox root;
    for (int i = 0; i < num_tris; ++i) {
        BBox b;
        b.extend(verts[3 * i]);
        b.extend(verts[3 * i + 1]);
        b.extend(verts[3 * i + 2]);
        refs[i] = {i, b};
        root.extend(b);
    }

    SBuilder sb;
    sb.verts = verts.data();
    sb.leaf_size = leaf_size;
    sb.root_area = std::max(root.half_area(), 1e-20f);
    sb.alpha = alpha;
    sb.budget = static_cast<long>(num_tris * (ref_budget - 1.0f)) + 16;
    const size_t max_refs =
        static_cast<size_t>(num_tris * ref_budget) + 16;
    const size_t node_cap = 4 * static_cast<size_t>(num_tris) + 2;
    sb.node_min.reserve(node_cap * 3);
    sb.node_max.reserve(node_cap * 3);
    sb.right.reserve(node_cap);
    sb.start.reserve(node_cap);
    sb.count.reserve(node_cap);
    sb.out_prims.reserve(max_refs);

    sb.build(refs);

    const int n_nodes = static_cast<int>(sb.right.size());
    if (static_cast<size_t>(n_nodes) > node_cap ||
        sb.out_prims.size() > max_refs)
        return -1;
    std::memcpy(out_node_min, sb.node_min.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_node_max, sb.node_max.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_right, sb.right.data(), sizeof(int) * n_nodes);
    std::memcpy(out_start, sb.start.data(), sizeof(int) * n_nodes);
    std::memcpy(out_count, sb.count.data(), sizeof(int) * n_nodes);
    std::memcpy(out_prim_ids, sb.out_prims.data(),
                sizeof(int) * sb.out_prims.size());
    *out_num_refs = static_cast<int>(sb.out_prims.size());
    return n_nodes;
}

// Returns the number of nodes, or -1 on error. Output arrays must hold at
// least 2 * num_tris entries (node arrays) / num_tris (prim_ids).
int imba_build_bvh(const float* bbox_lo, const float* bbox_hi,
                   const float* centers, int num_tris, int leaf_size,
                   float traversal_cost, float* out_node_min,
                   float* out_node_max, int* out_right, int* out_start,
                   int* out_count, int* out_prim_ids) {
    if (num_tris <= 0) return -1;

    std::vector<BBox> boxes(num_tris);
    std::vector<Vec3> cents(num_tris);
    for (int i = 0; i < num_tris; ++i) {
        boxes[i].lo = {bbox_lo[3 * i], bbox_lo[3 * i + 1], bbox_lo[3 * i + 2]};
        boxes[i].hi = {bbox_hi[3 * i], bbox_hi[3 * i + 1], bbox_hi[3 * i + 2]};
        cents[i] = {centers[3 * i], centers[3 * i + 1], centers[3 * i + 2]};
    }

    Builder b;
    b.boxes = boxes.data();
    b.centers = cents.data();
    b.leaf_size = leaf_size;
    b.traversal_cost = traversal_cost;
    b.prim_ids.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) b.prim_ids[i] = i;
    const size_t cap = 2 * static_cast<size_t>(num_tris) + 2;
    b.node_min.reserve(cap * 3);
    b.node_max.reserve(cap * 3);
    b.right.reserve(cap);
    b.start.reserve(cap);
    b.count.reserve(cap);

    b.build_range(0, num_tris);

    const int n_nodes = static_cast<int>(b.right.size());
    if (static_cast<size_t>(n_nodes) > cap) return -1;
    std::memcpy(out_node_min, b.node_min.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_node_max, b.node_max.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_right, b.right.data(), sizeof(int) * n_nodes);
    std::memcpy(out_start, b.start.data(), sizeof(int) * n_nodes);
    std::memcpy(out_count, b.count.data(), sizeof(int) * n_nodes);
    std::memcpy(out_prim_ids, b.prim_ids.data(), sizeof(int) * num_tris);
    return n_nodes;
}

}  // extern "C"
