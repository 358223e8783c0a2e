// Paged cluster-sweep closest hit for Hopper (sm_90a): scenes past the flat
// kernels' budget, repacked into pages of P clusters (ops/clusters.py
// build_pages; page g holds clusters [g*P, g*P + n_real[g]) and then
// padding clusters).
//
// Replaces the TPU kernel of the JAX package:
//   trace_paged_dnf_kernel <- pathtracing_tpu/ops/cluster_trace.py
//                             trace_pallas_paged_dnf (_tile_kernel_paged_dnf)
// under its contract: t_init <= 0 marks a dead lane and its t passes
// through; slot = cluster*128 + lane in the page-ordered numbering (-1 on a
// miss, with normal 0 and mat 0); the normal and material are read from
// the cluster tables. Paged occlusion is this kernel's slot >= 0, as in the
// JAX package.
//
// What bounds it on this card: operations, the Woop tests the rays need:
// each pair of a ray and a cluster box it pierces before its final hit,
// times 128 triangles, whatever order a kernel visits the boxes in. The
// tables (100 MB for a 1.3 M-triangle scene) exceed the 50 MB L2, so a
// page's Woop data streams from HBM while rays of many blocks share it.
//
// Design: the TPU grid of pages x ray tiles, with each ray's best t, slot,
// normal and mat carried from page to page through scratch memory, exists
// because Pallas grid steps run in order. Here one thread per ray sweeps
// the pages in order inside the kernel with its state in registers. Before
// a page, each lane slab-tests the page's bounds (the root box of its tree)
// against its best_t; a lane that misses them misses every box in the page,
// so it sits the page out, and the block skips a page that none of its
// lanes needs: earlier pages' hits cull later ones. Within a page the block
// sweeps only the real clusters, as trace_dnf_kernel sweeps a flat set
// (sweep_closest in cluster_common.cuh). Padding clusters are never
// visited: their inverted boxes would pass every slab test (the JAX kernel
// rewrites them as point boxes at +3e38 instead). Built with --fmad=false,
// so t, slot, normal and mat equal the plain version (trace_paged_dnf_torch,
// which equals trace_torch over the padded set) bit for bit.

#include "cluster_common.cuh"

using namespace ptpu;

namespace {

__global__ void __launch_bounds__(kBlock)
trace_paged_dnf_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_init,
                       const float* __restrict__ aabb_min,
                       const float* __restrict__ aabb_max,
                       const float* __restrict__ woop,
                       const float* __restrict__ normal,
                       const int* __restrict__ mat,
                       const float* __restrict__ page_tree_box,
                       const int* __restrict__ n_real, int n_rays,
                       int n_pages, int page_size, int page_nodes,
                       float* __restrict__ t_out, int* __restrict__ slot_out,
                       float* __restrict__ normal_out,
                       int* __restrict__ mat_out) {
  __shared__ float box[6][kBoxChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r = {};
  float best = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    best = t_init[i];
  }
  const bool live = in_range && best > 0.0f;
  int best_slot = -1;

  if (__syncthreads_or(live)) {
    for (int g = 0; g < n_pages; ++g) {
      // Column 0 of the page's (6, page_nodes) tree table is its root.
      const float* root =
          page_tree_box + static_cast<size_t>(g) * 6 * page_nodes;
      const bool want = live && slab_strided(root, page_nodes, r, best);
      if (!__syncthreads_or(want)) continue;
      const int c0 = g * page_size;
      sweep_closest(box, aabb_min, aabb_max, woop, c0, c0 + __ldg(n_real + g),
                    want, r, best, best_slot);
    }
  }
  if (in_range) {
    store_closest(i, best, best_slot, normal, mat, t_out, slot_out,
                  normal_out, mat_out);
  }
}

}  // namespace

extern "C" {

int ptpu_trace_paged_dnf(const float* origin, const float* direction,
                         const float* t_init, const float* aabb_min,
                         const float* aabb_max, const float* woop,
                         const float* normal, const int* mat,
                         const float* page_tree_box, const int* n_real,
                         int n_rays, int n_pages, int page_size,
                         int page_nodes, float* t_out, int* slot_out,
                         float* normal_out, int* mat_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  trace_paged_dnf_kernel<<<grid, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_init, aabb_min, aabb_max, woop, normal, mat,
      page_tree_box, n_real, n_rays, n_pages, page_size, page_nodes, t_out,
      slot_out, normal_out, mat_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
