// Cluster-sweep traversal kernels for Hopper (sm_90a): closest hit and
// any-hit of rays against 128-triangle Woop clusters.
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
// safe reciprocal of the direction.
//
// What bounds it on this card: operations. Each live ray slab-tests every
// cluster box (~20 float ops) and, for each box it pierces before its
// best_t, evaluates 128 Woop triangles (~45 float ops each). The bytes are
// small: 52 B per ray in and out, and the cluster tables (7.7 KB per
// cluster, 7.2 MB for cornell_mesh(6)) stay in the 50 MB L2.
//
// Design: one thread per ray, blocks of 128. Cluster boxes are staged in
// shared memory in chunks of 1024 (24 KB). The warp sweeps the clusters
// together in index order; each lane slab-tests against its own best_t
// and the warp skips a cluster with __any_sync when no lane needs it.
// Lanes that pierce a box evaluate its 128 triangles; the Woop columns
// are broadcast loads (every lane of the warp reads the same address).
// Strict < across clusters and the smallest lane on a tie within one
// reproduce the plain sweep's tie rule (trace_torch). The any-hit kernel
// retires a lane at its first hit and a warp once every lane is occluded
// or dead (no lane left pending, __any_sync). The TPU kernels' packed-key matrix, windowed pops
// and tile-uniform walk are not carried over: they exist only because the
// TPU has no per-lane gather or divergent control flow. Built with
// --fmad=false so every multiply and add rounds as in the plain torch
// version, which makes the card-side comparison exact in t.

#include "cluster_common.cuh"

using namespace ptpu;

namespace {

__global__ void __launch_bounds__(kBlock)
trace_dnf_kernel(const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_init,
                 const float* __restrict__ aabb_min,
                 const float* __restrict__ aabb_max,
                 const float* __restrict__ woop,
                 const float* __restrict__ normal,
                 const int* __restrict__ mat, int n_rays, int n_clusters,
                 float* __restrict__ t_out, int* __restrict__ slot_out,
                 float* __restrict__ normal_out, int* __restrict__ mat_out) {
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
    sweep_closest(box, aabb_min, aabb_max, woop, 0, n_clusters, live, r,
                  best, best_slot);
  }
  if (in_range) {
    store_closest(i, best, best_slot, normal, mat, t_out, slot_out,
                  normal_out, mat_out);
  }
}

__global__ void __launch_bounds__(kBlock)
occluded_dnf_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ t_max,
                    const float* __restrict__ aabb_min,
                    const float* __restrict__ aabb_max,
                    const float* __restrict__ woop, int n_rays,
                    int n_clusters, bool* __restrict__ occ_out) {
  __shared__ float box[6][kBoxChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r = {};
  float cap = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    cap = t_max[i];
  }
  bool pending = in_range && cap > 0.0f;  // live and not yet occluded
  bool occ = false;

  if (__syncthreads_or(pending)) {
    for (int c0 = 0; c0 < n_clusters; c0 += kBoxChunk) {
      const int n = min(kBoxChunk, n_clusters - c0);
      __syncthreads();
      stage_boxes(box, aabb_min, aabb_max, c0, n);
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        if (!__any_sync(kFull, pending)) break;  // whole warp finished
        const bool h = pending && slab(box, k, r, cap);
        if (!__any_sync(kFull, h)) continue;
        if (h && any_in_cluster(
                     woop + static_cast<size_t>(c0 + k) * 4 * kWoopCols, r,
                     cap)) {
          occ = true;
          pending = false;
        }
      }
    }
  }
  if (in_range) occ_out[i] = occ;
}

}  // namespace

extern "C" {

int ptpu_trace_dnf(const float* origin, const float* direction,
                   const float* t_init, const float* aabb_min,
                   const float* aabb_max, const float* woop,
                   const float* normal, const int* mat, int n_rays,
                   int n_clusters, float* t_out, int* slot_out,
                   float* normal_out, int* mat_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  trace_dnf_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_init, aabb_min, aabb_max, woop, normal, mat,
      n_rays, n_clusters, t_out, slot_out, normal_out, mat_out);
  return static_cast<int>(cudaGetLastError());
}

int ptpu_occluded_dnf(const float* origin, const float* direction,
                      const float* t_max, const float* aabb_min,
                      const float* aabb_max, const float* woop, int n_rays,
                      int n_clusters, bool* occ_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  occluded_dnf_kernel<<<grid, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_max, aabb_min, aabb_max, woop, n_rays,
      n_clusters, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
