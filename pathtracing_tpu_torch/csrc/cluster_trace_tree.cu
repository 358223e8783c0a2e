// Cluster-tree walks for Hopper (sm_90a): closest hit and any hit by a
// per-ray stackless walk of the threaded binary tree over cluster boxes
// (ops/clusters.py build_cluster_tree, build_octant_trees), and the closest
// hit by the same walk over each page's tree of a paged scene.
//
// Replaces the TPU kernels of the JAX package:
//   trace_tree_kernel       <- pathtracing_tpu/ops/cluster_trace.py
//                              trace_pallas (_tile_kernel_la, _tile_kernel)
//   occluded_tree_kernel    <- occluded_pallas (_tile_kernel_occ_la,
//                              _tile_kernel_occ)
//   trace_tree_paged_kernel <- trace_pallas_paged (_tile_kernel_paged)
// under their contract: t_init / t_max caps the search and <= 0 marks a
// dead lane (t passed through); slot = cluster*128 + lane (-1 on a miss,
// with normal 0 and mat 0); in a paged scene the slot is global,
// (page*P + page-local cluster)*128 + lane. The normal is the winner's
// Woop w-row, normalised with rsqrt, as the JAX tree kernels compute it.
//
// What bounds them on this card: operations, the Woop tests the rays need:
// each pair of a ray and a cluster box it pierces before its final hit (for
// the any hit: before its cap, one cluster for an occluded ray), times 128
// triangles. The walk adds one slab test per visited node, and evaluates
// every cluster it reaches before the ray's best hit so far. Node boxes
// (24 B a node, 0.7 MB for a 29,471-node tree) stay in L2.
//
// Design: the TPU walks one scalar node index per 256-ray tile, with the
// tile's octant taken from its first ray, a K-step lookahead over
// precomputed candidate boxes and a leaf queue, because Mosaic has no
// per-lane control flow or gather. Here each thread walks its own ray: it
// picks its own direction octant (x>0 -> +4, y>0 -> +2, z>0 -> +1; a zero
// component counts as negative), reads each node's box from global memory,
// and follows next = hit ? hit_link[oct][n] : miss_link[oct][n] until n >=
// N. The octant order visits near children first, so early hits cull the
// subtrees behind them.
//   trace_tree_kernel holds each leaf it pierces before its best t and
// evaluates it with the whole warp: the walker of cluster_walk.cuh
// (warp_walk<kPaged = false>), shared with the flat and the paged closest
// hits; every lane of the warp reaches it, out-of-range lanes with live =
// false. Its epilogue (store_tree_hit) takes the normal from the winner's
// Woop w-row.
//   occluded_tree_kernel and trace_tree_paged_kernel (walk_tree) still
// evaluate each leaf on the lane that reached it, which retires at its
// first hit in the any hit; divergence between the lanes of a warp is the
// cost of that first design.
// The (t, index) reduction keeps the smallest index on a tie, as the serial
// scan does, and the sources are built with --fmad=false, so t, slot,
// normal and mat equal the plain per-ray walks (trace_tree_torch,
// occluded_tree_torch, trace_tree_paged_torch) bit for bit.

#include "cluster_walk.cuh"

using namespace ptpu;

namespace {

// Walk one threaded tree: node_box (6, N), node_meta (2, N) [skip, cluster
// id or -1], links (16, N) [hit links of octants 0..7, then miss links].
// Leaf ids are offset by cid_base. Closest hit: updates best and
// best_slot. kAnyHit: best is the fixed cap; returns true at the first
// triangle hit.
template <bool kAnyHit>
__device__ __forceinline__ bool walk_tree(
    const float* __restrict__ node_box, const int* __restrict__ node_meta,
    const int* __restrict__ links, int n_nodes,
    const float* __restrict__ woop, int cid_base, const Ray& r, int oct,
    float& best, int& best_slot) {
  int n = 0;
  while (n < n_nodes) {
    const bool hit = slab_strided(node_box + n, n_nodes, r, best);
    const int cid = __ldg(node_meta + n_nodes + n);
    if (hit && cid >= 0) {
      const int c = cid_base + cid;
      const float* w = woop + static_cast<size_t>(c) * 4 * kWoopCols;
      if (kAnyHit) {
        if (any_in_cluster(w, r, best)) return true;
      } else {
        int lane_min;
        const float t_min = closest_in_cluster(w, r, best, lane_min);
        if (t_min < best) {
          best = t_min;
          best_slot = c * kClusterSize + lane_min;
        }
      }
    }
    n = __ldg(links + static_cast<size_t>(hit ? oct : 8 + oct) * n_nodes +
              n);
  }
  return false;
}

// Ray i's closest-hit result; the normal from the winner's Woop w-row.
__device__ __forceinline__ void store_tree_hit(
    int i, float best, int best_slot, const float* __restrict__ woop,
    const int* __restrict__ mat, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ normal_out,
    int* __restrict__ mat_out) {
  t_out[i] = best;
  slot_out[i] = best_slot;
  if (best_slot < 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) normal_out[3 * i + a] = 0.0f;
    mat_out[i] = 0;
    return;
  }
  const int c = best_slot / kClusterSize;
  const int lane = best_slot % kClusterSize;
  const float* w = woop + static_cast<size_t>(c) * 4 * kWoopCols +
                   2 * kClusterSize + lane;
  const float nx = w[0];
  const float ny = w[kWoopCols];
  const float nz = w[2 * kWoopCols];
  const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
  normal_out[3 * i + 0] = nx * inv_len;
  normal_out[3 * i + 1] = ny * inv_len;
  normal_out[3 * i + 2] = nz * inv_len;
  mat_out[i] = mat[static_cast<size_t>(c) * kClusterSize + lane];
}

__global__ void __launch_bounds__(kBlock)
trace_tree_kernel(const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_init,
                  const float* __restrict__ node_box,
                  const int* __restrict__ node_meta,
                  const int* __restrict__ links,
                  const float* __restrict__ woop,
                  const int* __restrict__ mat, int n_rays, int n_nodes,
                  float* __restrict__ t_out, int* __restrict__ slot_out,
                  float* __restrict__ normal_out, int* __restrict__ mat_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r = {};
  float best = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    best = t_init[i];
  }
  int best_slot = -1;
  bool unused = false;
  warp_walk<false, false>(woop, node_box, node_meta, links, 1, 0, n_nodes,
                          in_range && best > 0.0f, r, best, best_slot,
                          unused);
  if (in_range) {
    store_tree_hit(i, best, best_slot, woop, mat, t_out, slot_out,
                   normal_out, mat_out);
  }
}

__global__ void __launch_bounds__(kBlock)
occluded_tree_kernel(const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ t_max,
                     const float* __restrict__ node_box,
                     const int* __restrict__ node_meta,
                     const int* __restrict__ links,
                     const float* __restrict__ woop, int n_rays,
                     int n_nodes, bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(origin, direction, i);
  float cap = t_max[i];
  int unused = -1;
  occ_out[i] = cap > 0.0f &&
               walk_tree<true>(node_box, node_meta, links, n_nodes, woop, 0,
                               r, octant(r), cap, unused);
}

__global__ void __launch_bounds__(kBlock)
trace_tree_paged_kernel(const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_init,
                        const float* __restrict__ node_box,
                        const int* __restrict__ node_meta,
                        const int* __restrict__ links,
                        const float* __restrict__ woop,
                        const int* __restrict__ mat, int n_rays, int n_pages,
                        int page_nodes, int page_size,
                        float* __restrict__ t_out, int* __restrict__ slot_out,
                        float* __restrict__ normal_out,
                        int* __restrict__ mat_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(origin, direction, i);
  float best = t_init[i];
  int best_slot = -1;
  if (best > 0.0f) {
    const int oct = octant(r);
    for (int g = 0; g < n_pages; ++g) {
      const size_t p = static_cast<size_t>(g) * page_nodes;
      walk_tree<false>(node_box + 6 * p, node_meta + 2 * p, links + 16 * p,
                       page_nodes, woop, g * page_size, r, oct, best,
                       best_slot);
    }
  }
  store_tree_hit(i, best, best_slot, woop, mat, t_out, slot_out, normal_out,
                 mat_out);
}

int launch_grid(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

int ptpu_trace_tree(const float* origin, const float* direction,
                    const float* t_init, const float* node_box,
                    const int* node_meta, const int* links,
                    const float* woop, const int* mat, int n_rays,
                    int n_nodes, float* t_out, int* slot_out,
                    float* normal_out, int* mat_out, void* stream) {
  if (n_rays <= 0) return 0;
  trace_tree_kernel<<<launch_grid(n_rays), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_init, node_box, node_meta, links, woop, mat,
      n_rays, n_nodes, t_out, slot_out, normal_out, mat_out);
  return static_cast<int>(cudaGetLastError());
}

int ptpu_occluded_tree(const float* origin, const float* direction,
                       const float* t_max, const float* node_box,
                       const int* node_meta, const int* links,
                       const float* woop, int n_rays, int n_nodes,
                       bool* occ_out, void* stream) {
  if (n_rays <= 0) return 0;
  occluded_tree_kernel<<<launch_grid(n_rays), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_max, node_box, node_meta, links, woop, n_rays,
      n_nodes, occ_out);
  return static_cast<int>(cudaGetLastError());
}

int ptpu_trace_tree_paged(const float* origin, const float* direction,
                          const float* t_init, const float* node_box,
                          const int* node_meta, const int* links,
                          const float* woop, const int* mat, int n_rays,
                          int n_pages, int page_nodes, int page_size,
                          float* t_out, int* slot_out, float* normal_out,
                          int* mat_out, void* stream) {
  if (n_rays <= 0) return 0;
  trace_tree_paged_kernel<<<launch_grid(n_rays), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_init, node_box, node_meta, links, woop, mat,
      n_rays, n_pages, page_nodes, page_size, t_out, slot_out, normal_out,
      mat_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
