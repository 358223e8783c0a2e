// Cluster-tree walks for Hopper (sm_90a): closest hit and any hit by a
// per-ray stackless walk of the threaded binary tree over cluster boxes
// (ops/clusters.py build_cluster_tree, build_octant_trees) of an unpaged
// scene past the flat budget, and the closest hit by the same walk over
// each page's tree of a paged scene.
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
// triangles of 48 float32 operations on the CUDA cores, or, for the any
// hit, the bytes of the Woop rows (6,144 B a cluster: 90.5 MB for the
// 14,736 clusters of cornell_mesh(8), past the 50 MB L2) and of the tree.
// The walk adds one slab test per visited node.
//
// Design: the TPU walks one scalar node index per 256-ray tile, with the
// tile's octant taken from its first ray, a K-step lookahead over
// precomputed candidate boxes and a leaf queue, because Mosaic has no
// per-lane control flow or gather. Here each lane walks its own ray along
// its own direction octant (near children first, so early hits cull the
// subtrees behind them), holds each leaf it pierces, and the warp
// evaluates the held leaves together, four triangles a lane with coalesced
// Woop loads: all three kernels are the shared walker of cluster_walk.cuh,
//   trace_tree_kernel       closest_hit_walk<kPaged = false>, the one tree;
//   occluded_tree_kernel    any_hit_walk<kPaged = false>, the cap fixed and
//                           a lane retired at its first occluding cluster
//                           (row 2's flat any hit runs the same body);
//   trace_tree_paged_kernel closest_hit_walk<kPaged = true>: each page's
//                           tree, pages nearest first, as the paged closest
//                           hit (cluster_trace_paged.cu) walks them;
// both closest hits with the Woop-row epilogue (store_tree_hit). Every
// lane of a warp reaches the walker, out-of-range and dead lanes with live
// = false. The (t, index) reduction keeps the smallest index on a tie, and
// the sources are built with --fmad=false, so t, slot, normal and mat
// equal the plain walks in the kernels' order (trace_tree_torch,
// occluded_tree_torch, trace_tree_paged_walk_torch) bit for bit.

#include "cluster_walk.cuh"

using namespace ptpu;

namespace {

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
  closest_hit_walk<false, true>(origin, direction, t_init, woop, nullptr, mat,
                                node_box, node_meta, links, n_rays, 1, 0,
                                n_nodes, t_out, slot_out, normal_out,
                                mat_out);
}

// At least two blocks per SM, as row 2's any hit on the same body: under
// the bare bound ptxas (CUDA 12.8) spilled that one.
__global__ void __launch_bounds__(kBlock, 2)
occluded_tree_kernel(const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ t_max,
                     const float* __restrict__ node_box,
                     const int* __restrict__ node_meta,
                     const int* __restrict__ links,
                     const float* __restrict__ woop, int n_rays,
                     int n_nodes, bool* __restrict__ occ_out) {
  any_hit_walk<false>(origin, direction, t_max, woop, node_box, node_meta,
                      links, n_rays, 1, 0, n_nodes, occ_out);
}

// The C interface's argument order (n_pages, page_nodes, page_size) is
// kept; the walker takes (n_pages, page_size, page_nodes).
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
  closest_hit_walk<true, true>(origin, direction, t_init, woop, nullptr, mat,
                               node_box, node_meta, links, n_rays, n_pages,
                               /*page_size=*/page_size,
                               /*page_nodes=*/page_nodes, t_out, slot_out,
                               normal_out, mat_out);
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
