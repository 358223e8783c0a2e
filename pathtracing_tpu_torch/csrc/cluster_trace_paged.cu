// Paged cluster traversal for Hopper (sm_90a), closest hit and any hit:
// scenes past the flat kernels' budget, repacked into pages of P clusters
// (ops/clusters.py build_pages; page g holds clusters [g*P, g*P +
// n_real[g]) and then padding clusters), each page with its own threaded
// cluster tree (PageSet.node_box, node_meta, oct_links).
//
// Replaces the TPU kernel of the JAX package:
//   trace_paged_dnf_kernel    <- pathtracing_tpu/ops/cluster_trace.py
//                                trace_pallas_paged_dnf
//                                (_tile_kernel_paged_dnf)
//   occluded_paged_dnf_kernel <- the same kernel's slot >= 0, which the JAX
//                                package uses for paged occlusion
// under its contract: t_init / t_max <= 0 marks a dead lane and its t
// passes through; slot = cluster*128 + lane in the page-ordered numbering
// (-1 on a miss, with normal 0 and mat 0); the normal and material are read
// from the cluster tables.
//
// What bounds it on this card: operations, the Woop tests the rays need:
// each pair of a ray and a cluster box it pierces before its final hit (any
// hit: before its cap, one pair for an occluded ray), times 128 triangles
// of 48 float32 operations on the CUDA cores. The tensor cores stay out:
// the Woop tests are multiply-adds that must round as the plain version
// does, and TF32 breaks geometry. The tables (100 MB for a 1.3 M-triangle
// scene) exceed the 50 MB L2.
//
// Design. The TPU sweeps every box of a page per ray tile, because Mosaic
// has no per-lane control flow; a first Hopper design that kept the sweep
// slab-tested all of a page's boxes per warp, and that set its time. Here
// each lane walks each page's tree along its own direction octant and
// visits its pages nearest first: the order of their root boxes' entry
// distances (sorted by selection, ties by page index), stopping at the
// first page it enters no earlier than its best t. Leaves are real
// clusters only, so padding clusters are never visited. Leaves are held
// one per lane and evaluated by the whole warp: the walker in
// cluster_walk.cuh (closest_hit_walk<kPaged = true> and
// any_hit_walk<kPaged = true>; the tree route's per-page closest hit is
// the same walk with the Woop-row normal). The any hit retires a lane at its first
// occluding cluster (a warp ballot). Built with --fmad=false, so t, slot,
// normal and mat equal the plain version
// (cluster_trace.trace_paged_walk_torch) bit for bit, and occlusion equals
// trace_paged_dnf_torch's slot >= 0.

#include "cluster_walk.cuh"

using namespace ptpu;

namespace {

__global__ void __launch_bounds__(kBlock)
trace_paged_dnf_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_init,
                       const float* __restrict__ woop,
                       const float* __restrict__ normal,
                       const int* __restrict__ mat,
                       const float* __restrict__ node_box,
                       const int* __restrict__ node_meta,
                       const int* __restrict__ links, int n_rays,
                       int n_pages, int page_size, int page_nodes,
                       float* __restrict__ t_out, int* __restrict__ slot_out,
                       float* __restrict__ normal_out,
                       int* __restrict__ mat_out) {
  closest_hit_walk<true, false>(origin, direction, t_init, woop, normal, mat,
                                node_box, node_meta, links, n_rays, n_pages,
                                page_size, page_nodes, t_out, slot_out,
                                normal_out, mat_out);
}

__global__ void __launch_bounds__(kBlock)
occluded_paged_dnf_kernel(const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const float* __restrict__ t_max,
                          const float* __restrict__ woop,
                          const float* __restrict__ node_box,
                          const int* __restrict__ node_meta,
                          const int* __restrict__ links, int n_rays,
                          int n_pages, int page_size, int page_nodes,
                          bool* __restrict__ occ_out) {
  any_hit_walk<true>(origin, direction, t_max, woop, node_box, node_meta,
                     links, n_rays, n_pages, page_size, page_nodes, occ_out);
}

int launch_grid(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

int ptpu_trace_paged_dnf(const float* origin, const float* direction,
                         const float* t_init, const float* woop,
                         const float* normal, const int* mat,
                         const float* node_box, const int* node_meta,
                         const int* links, int n_rays, int n_pages,
                         int page_size, int page_nodes, float* t_out,
                         int* slot_out, float* normal_out, int* mat_out,
                         void* stream) {
  if (n_rays <= 0) return 0;
  trace_paged_dnf_kernel<<<launch_grid(n_rays), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_init, woop, normal, mat, node_box, node_meta,
      links, n_rays, n_pages, page_size, page_nodes, t_out, slot_out,
      normal_out, mat_out);
  return static_cast<int>(cudaGetLastError());
}

int ptpu_occluded_paged_dnf(const float* origin, const float* direction,
                            const float* t_max, const float* woop,
                            const float* node_box, const int* node_meta,
                            const int* links, int n_rays, int n_pages,
                            int page_size, int page_nodes, bool* occ_out,
                            void* stream) {
  if (n_rays <= 0) return 0;
  occluded_paged_dnf_kernel<<<launch_grid(n_rays), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_max, woop, node_box, node_meta, links, n_rays,
      n_pages, page_size, page_nodes, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
