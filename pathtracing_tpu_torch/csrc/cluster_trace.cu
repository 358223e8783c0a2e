// Flat cluster traversal kernels for Hopper (sm_90a): closest hit and any
// hit of rays against 128-triangle Woop clusters of a flat ClusterSet (at
// most DNF_MAX_CLUSTERS clusters).
//
// Replaces the TPU kernels of the JAX package:
//   trace_dnf_kernel    <- pathtracing_tpu/ops/cluster_trace.py
//                          trace_pallas_dnf (_tile_kernel_dnf)
//   occluded_dnf_kernel <- pathtracing_tpu/ops/cluster_trace.py
//                          occluded_pallas_dnf (_tile_kernel_occ_dnf)
// under the same contract: t_init / t_max caps the search and <= 0 marks a
// dead lane; slot = cluster*128 + lane (-1 on a miss, with normal 0 and
// mat 0 and t passed through); a hit needs u >= 0, v >= 0, u+v <= 1,
// T_MIN < t < best_t with |dp_w| clamped at 1e-30; the slab test uses the
// safe reciprocal of the direction; normal and material are read from the
// cluster tables.
//
// What bounds them on this card: operations, the Woop tests the rays need:
// each pair of a live ray and a cluster box it pierces before its final
// hit (any hit: before its cap, one pair for an occluded ray), times 128
// triangles of 48 float32 operations on the CUDA cores. The tensor cores
// stay out: the Woop tests must round as the plain versions do, and TF32
// breaks geometry. The bytes are small: 52 B per ray in and out, and the
// cluster tables (7.7 KB per cluster, 7.2 MB for cornell_mesh(6)) and the
// tree (96 B a node) stay in the 50 MB L2.
//
// Design of the closest hit (trace_dnf_kernel). The TPU sweeps every
// cluster box per ray tile, because Mosaic has no per-lane control flow;
// the first Hopper design kept that sweep, slab-testing all boxes per warp
// and evaluating a pierced cluster's 128 triangles on one lane. Here each
// lane walks the flat set's threaded cluster tree (ClusterSet.node_box,
// node_meta, oct_links) along its own direction octant, near children
// first, so early hits cull the subtrees behind them; leaves are held one
// per lane and evaluated by the whole warp, four triangles a lane with
// coalesced Woop loads: the walker of cluster_walk.cuh
// (closest_hit_walk<kPaged = false>), which the paged and the tree
// closest hits share. The (t, index) reduction keeps the smallest index on a tie, and
// strict < across clusters keeps the first cluster of the walk, so t,
// slot, normal and mat equal the plain walk (trace_flat_walk_torch) bit
// for bit. Against the index-order sweep (trace_torch, the JAX order) t is
// equal bit for bit and the slot too, except where two clusters tie in t.
//
// Design of the any hit (occluded_dnf_kernel). The first Hopper design
// kept the TPU's sweep: every cluster box in index order for every warp,
// a pierced cluster's 128 triangles tested on one lane. Here the any hit
// takes the closest hit's walk of the same tree (any_hit_walk<kPaged =
// false>, the body of the tree route's any hit too): the cap stays fixed,
// and a lane retires at its first occluding cluster. Whether some triangle lies strictly inside
// (T_MIN, cap) does not depend on the order of visits, so the bool equals
// the plain walk (occluded_tree_torch) and the index-order sweep
// (occluded_torch, the JAX order) alike. The tree's leaves are the set's
// real clusters only.
//
// Built with --fmad=false so every multiply and add rounds as in the plain
// torch versions, which makes the card-side comparison exact.

#include "cluster_walk.cuh"

using namespace ptpu;

namespace {

// At least two blocks per SM: under the bare bound ptxas (CUDA 12.8,
// sm_90a) settled on 80 registers and spilled a 16-bit temporary to the
// stack; this target gives 99 registers and no spills.
__global__ void __launch_bounds__(kBlock, 2)
trace_dnf_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_init,
                 const float* __restrict__ woop,
                 const float* __restrict__ normal,
                 const int* __restrict__ mat,
                 const float* __restrict__ node_box,
                 const int* __restrict__ node_meta,
                 const int* __restrict__ links, int n_rays, int n_nodes,
                 float* __restrict__ t_out, int* __restrict__ slot_out,
                 float* __restrict__ normal_out, int* __restrict__ mat_out) {
  closest_hit_walk<false, false>(origin, direction, t_init, woop, normal, mat,
                                 node_box, node_meta, links, n_rays, 1, 0,
                                 n_nodes, t_out, slot_out, normal_out,
                                 mat_out);
}

__global__ void __launch_bounds__(kBlock, 2)
occluded_dnf_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ t_max,
                    const float* __restrict__ woop,
                    const float* __restrict__ node_box,
                    const int* __restrict__ node_meta,
                    const int* __restrict__ links, int n_rays, int n_nodes,
                    bool* __restrict__ occ_out) {
  any_hit_walk<false>(origin, direction, t_max, woop, node_box, node_meta,
                      links, n_rays, 1, 0, n_nodes, occ_out);
}

}  // namespace

extern "C" {

int ptpu_trace_dnf(const float* origin, const float* direction,
                   const float* t_init, const float* woop,
                   const float* normal, const int* mat,
                   const float* node_box, const int* node_meta,
                   const int* links, int n_rays, int n_nodes, float* t_out,
                   int* slot_out, float* normal_out, int* mat_out,
                   void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  trace_dnf_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_init, woop, normal, mat, node_box, node_meta,
      links, n_rays, n_nodes, t_out, slot_out, normal_out, mat_out);
  return static_cast<int>(cudaGetLastError());
}

int ptpu_occluded_dnf(const float* origin, const float* direction,
                      const float* t_max, const float* woop,
                      const float* node_box, const int* node_meta,
                      const int* links, int n_rays, int n_nodes,
                      bool* occ_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  occluded_dnf_kernel<<<grid, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_max, woop, node_box, node_meta, links, n_rays,
      n_nodes, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
