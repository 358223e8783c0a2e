// Host SAH BVH builder of the PyTorch/CUDA port: a copy of the JAX
// package's native/bvh_builder.cpp, kept here so the port stands alone.
// ops/bvh_native.py compiles it with the host C++ compiler at first use
// (into the git-ignored .build/) and loads it with ctypes.
//
// Produces exactly the threaded skip-link layout of
// pathtracing_tpu_torch/ops/bvh.py::_build_bvh_numpy — nodes in DFS
// preorder, interior hit-successor implicit (i+1), miss/skip link to the
// subtree end, leaves owning contiguous primitive ranges of a permutation
// array. The NumPy builder is the reference implementation; this one
// exists for build-time throughput on large meshes (the leaf-4 build of a
// 1.3 M-triangle mesh takes minutes in NumPy).
//
// Exported C ABI (ctypes-friendly):
//   ptpu_build_bvh(v0, e1, e2, n, leaf_size, sah_bins,
//                  node_min, node_max, node_meta, perm, out_node_count)
// Caller allocates node arrays with capacity 2*max(n,1) and perm with n.
// Returns 0 on success.

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

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float axis_of(const Vec3 &v, int ax) {
  return ax == 0 ? v.x : (ax == 1 ? v.y : v.z);
}
inline float half_area(const Vec3 &mn, const Vec3 &mx) {
  float dx = std::max(mx.x - mn.x, 0.0f);
  float dy = std::max(mx.y - mn.y, 0.0f);
  float dz = std::max(mx.z - mn.z, 0.0f);
  return dx * dy + dy * dz + dz * dx;
}

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr double kIntersectCost = 1.5;  // ops/bvh.py INTERSECT_COST

struct Builder {
  const Vec3 *prim_min, *prim_max, *centroid;
  int leaf_size, sah_bins;
  float *node_min, *node_max;
  std::int32_t *node_meta;
  std::int64_t *perm;
  std::int64_t node_count = 0;
  std::vector<std::int32_t> subtree_end;

  // Iterative preorder emission with an explicit range stack. Each frame
  // is processed twice: first to emit the node and push children, then a
  // sentinel pops to patch the skip link once the subtree size is known.
  struct Frame {
    std::int64_t first, count;
    std::int64_t node = -1;  // -1: not yet emitted; else: patch pass
  };

  void run(std::int64_t n) {
    std::vector<Frame> stack;
    stack.push_back({0, n, -1});
    while (!stack.empty()) {
      Frame f = stack.back();
      stack.pop_back();
      if (f.node >= 0) {  // patch pass
        subtree_end[f.node] = static_cast<std::int32_t>(node_count);
        continue;
      }
      std::int64_t my = node_count++;
      // Node bounds over the current range.
      Vec3 bmin = {kInf, kInf, kInf}, bmax = {-kInf, -kInf, -kInf};
      Vec3 cmin = {kInf, kInf, kInf}, cmax = {-kInf, -kInf, -kInf};
      for (std::int64_t i = f.first; i < f.first + f.count; ++i) {
        std::int64_t p = perm[i];
        bmin = vmin(bmin, prim_min[p]);
        bmax = vmax(bmax, prim_max[p]);
        cmin = vmin(cmin, centroid[p]);
        cmax = vmax(cmax, centroid[p]);
      }
      node_min[my * 3 + 0] = bmin.x;
      node_min[my * 3 + 1] = bmin.y;
      node_min[my * 3 + 2] = bmin.z;
      node_max[my * 3 + 0] = bmax.x;
      node_max[my * 3 + 1] = bmax.y;
      node_max[my * 3 + 2] = bmax.z;

      if (f.count <= leaf_size) {
        node_meta[my * 3 + 0] = 0;  // skip patched after build
        node_meta[my * 3 + 1] = static_cast<std::int32_t>(f.first);
        node_meta[my * 3 + 2] = static_cast<std::int32_t>(f.count);
        subtree_end[my] = static_cast<std::int32_t>(node_count);
        continue;
      }

      Vec3 ext = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
      int axis = 0;
      if (ext.y > axis_of(ext, axis)) axis = 1;
      if (ext.z > axis_of(ext, axis)) axis = 2;
      float extent = axis_of(ext, axis);

      std::int64_t split = -1;
      std::int64_t *base = perm + f.first;
      if (extent > 1e-12f) {
        // Binned SAH along the widest centroid axis.
        const int nb = sah_bins;
        float lo = axis_of(cmin, axis);
        float scale = nb * (1.0f - 1e-6f) / extent;
        std::vector<std::int64_t> counts(nb, 0);
        std::vector<Vec3> bmn(nb, {kInf, kInf, kInf});
        std::vector<Vec3> bmx(nb, {-kInf, -kInf, -kInf});
        for (std::int64_t i = 0; i < f.count; ++i) {
          std::int64_t p = base[i];
          int b = std::min(
              static_cast<int>((axis_of(centroid[p], axis) - lo) * scale),
              nb - 1);
          counts[b]++;
          bmn[b] = vmin(bmn[b], prim_min[p]);
          bmx[b] = vmax(bmx[b], prim_max[p]);
        }
        // Prefix/suffix sweeps. The costs are doubles, count times the
        // float half area, as NumPy promotes int64 * float32 in the
        // reference: a float cost can pick another bin on a near-tie.
        std::vector<double> lcost(nb), rcost(nb);
        std::vector<std::int64_t> lcnt(nb);
        Vec3 amn = {kInf, kInf, kInf}, amx = {-kInf, -kInf, -kInf};
        std::int64_t acc = 0;
        for (int b = 0; b < nb; ++b) {
          amn = vmin(amn, bmn[b]);
          amx = vmax(amx, bmx[b]);
          acc += counts[b];
          lcnt[b] = acc;
          lcost[b] = static_cast<double>(acc) * half_area(amn, amx);
        }
        amn = {kInf, kInf, kInf};
        amx = {-kInf, -kInf, -kInf};
        acc = 0;
        for (int b = nb - 1; b >= 0; --b) {
          amn = vmin(amn, bmn[b]);
          amx = vmax(amx, bmx[b]);
          acc += counts[b];
          rcost[b] = static_cast<double>(acc) * half_area(amn, amx);
        }
        int best = -1;
        double best_cost = std::numeric_limits<double>::infinity();
        for (int b = 0; b < nb - 1; ++b) {
          if (lcnt[b] == 0 || lcnt[b] == f.count) continue;
          const double c = kIntersectCost * (lcost[b] + rcost[b + 1]);
          if (c < best_cost) {
            best_cost = c;
            best = b;
          }
        }
        if (best >= 0) {
          // Stable partition by bin <= best (matches NumPy's stable sort
          // of the boolean selector).
          std::stable_partition(base, base + f.count,
                                [&](std::int64_t p) {
            int b = std::min(static_cast<int>(
                (axis_of(centroid[p], axis) - lo) * scale), nb - 1);
            return b <= best;
          });
          split = lcnt[best];
        }
      }
      if (split <= 0 || split >= f.count) {
        // Degenerate centroids: median split on a stable sort.
        std::stable_sort(base, base + f.count,
                         [&](std::int64_t a, std::int64_t b) {
          return axis_of(centroid[a], axis) < axis_of(centroid[b], axis);
        });
        split = f.count / 2;
      }

      node_meta[my * 3 + 0] = 0;
      node_meta[my * 3 + 1] = 0;
      node_meta[my * 3 + 2] = 0;  // interior
      // Preorder: left child next. Push patch frame first, then right,
      // then left (LIFO).
      stack.push_back({f.first, f.count, my});
      stack.push_back({f.first + split, f.count - split, -1});
      stack.push_back({f.first, split, -1});
    }
  }
};

}  // namespace

extern "C" int ptpu_build_bvh(
    const float *v0, const float *e1, const float *e2, std::int64_t n,
    std::int32_t leaf_size, std::int32_t sah_bins,
    float *node_min, float *node_max, std::int32_t *node_meta,
    std::int64_t *perm, std::int64_t *out_node_count) {
  if (n <= 0) {
    node_min[0] = node_min[1] = node_min[2] = 0.0f;
    node_max[0] = node_max[1] = node_max[2] = 0.0f;
    node_meta[0] = 1;
    node_meta[1] = 0;
    node_meta[2] = 0;
    *out_node_count = 1;
    return 0;
  }

  std::vector<Vec3> pmin(n), pmax(n), cent(n);
  for (std::int64_t i = 0; i < n; ++i) {
    Vec3 a = {v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
    Vec3 b = {a.x + e1[i * 3], a.y + e1[i * 3 + 1], a.z + e1[i * 3 + 2]};
    Vec3 c = {a.x + e2[i * 3], a.y + e2[i * 3 + 1], a.z + e2[i * 3 + 2]};
    pmin[i] = vmin(a, vmin(b, c));
    pmax[i] = vmax(a, vmax(b, c));
    cent[i] = {(pmin[i].x + pmax[i].x) * 0.5f,
               (pmin[i].y + pmax[i].y) * 0.5f,
               (pmin[i].z + pmax[i].z) * 0.5f};
    perm[i] = i;
  }

  Builder bld;
  bld.prim_min = pmin.data();
  bld.prim_max = pmax.data();
  bld.centroid = cent.data();
  bld.leaf_size = leaf_size;
  bld.sah_bins = sah_bins;
  bld.node_min = node_min;
  bld.node_max = node_max;
  bld.node_meta = node_meta;
  bld.perm = perm;
  bld.subtree_end.resize(2 * n);
  bld.run(n);

  for (std::int64_t i = 0; i < bld.node_count; ++i) {
    node_meta[i * 3 + 0] = bld.subtree_end[i];
  }
  *out_node_count = bld.node_count;
  return 0;
}
