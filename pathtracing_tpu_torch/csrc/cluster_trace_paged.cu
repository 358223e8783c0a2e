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
// each lane walks each page's tree along its own direction octant, as
// trace_tree_paged_kernel does, and visits its pages nearest first: the
// order of their root boxes' entry distances (sorted by selection, ties by
// page index), stopping at the first page it enters no earlier than its
// best t. Leaves are real clusters only, so padding clusters are never
// visited. A lane that reaches a leaf it pierces holds it and waits; when
// every lane of the warp holds a leaf or has finished, the warp evaluates
// the held pairs together (warp_closest_group / warp_any_group in
// cluster_common.cuh): lanes holding one cluster are grouped with
// __match_any_sync and share its coalesced Woop loads, each pair takes 32
// lanes of four triangles, and the (t, index) reduction keeps the smallest
// index on a tie, as the serial scan does. Holding one leaf at a time keeps
// each ray's sequence of leaves and caps that of the plain walk. The any
// hit retires a lane at its first occluding cluster (a warp ballot). Built
// with --fmad=false, so t, slot, normal and mat equal the plain version
// (cluster_trace.trace_paged_walk_torch) bit for bit, and occlusion equals
// trace_paged_dnf_torch's slot >= 0.

#include "cluster_common.cuh"

using namespace ptpu;

namespace {

// Entry distance of a ray into a page's root box (column 0 of its (6,
// page_nodes) table), kBig when the ray misses the box: entry < best
// exactly when slab_strided passes against best.
__device__ __forceinline__ float page_entry(const float* root,
                                            int page_nodes, const Ray& r) {
  float tn, tf;
  slab_range(root, root + 3 * page_nodes, page_nodes, r, tn, tf);
  return (tn <= tf && tf > kTMin) ? tn : kBig;
}

// The warp walks its lanes' rays through the pages (see the note above).
// Closest hit: updates best and best_slot. kAnyHit: best is the fixed cap
// and `occluded` is set at the first hit. Every lane of the warp calls it.
template <bool kAnyHit>
__device__ __forceinline__ void paged_walk(
    const float* __restrict__ woop, const float* __restrict__ node_box,
    const int* __restrict__ node_meta, const int* __restrict__ links,
    int n_pages, int page_size, int page_nodes, bool live, const Ray& r,
    float& best, int& best_slot, bool& occluded) {
  const int lane = threadIdx.x % kWarp;
  const int oct = octant(r);
  bool walking = live;
  int g = -1;                   // page being walked, -1 between pages
  int n = 0;                    // its next node
  float last_e = -kBig;         // entry and index of the page walked last
  int last_g = -1;              // (every page comes after these)
  for (;;) {
    int held = -1;              // global id of the leaf this lane holds
    while (walking) {
      if (g < 0) {
        // The next page in (entry, index) order after the last one.
        float next_e = __int_as_float(0x7f800000);  // +inf
        int next_g = -1;
        for (int p = 0; p < n_pages; ++p) {
          const float e = page_entry(
              node_box + static_cast<size_t>(p) * 6 * page_nodes, page_nodes,
              r);
          const bool later = e > last_e || (e == last_e && p > last_g);
          if (later && e < next_e) {
            next_e = e;
            next_g = p;
          }
        }
        // Pages come nearest first: none after this one can be entered.
        if (next_g < 0 || !(next_e < best)) {
          walking = false;
          break;
        }
        g = next_g;
        n = 0;
        last_e = next_e;
        last_g = next_g;
      }
      if (n >= page_nodes) {
        g = -1;
        continue;
      }
      const size_t base = static_cast<size_t>(g) * page_nodes;
      const bool hit = slab_strided(node_box + 6 * base + n, page_nodes, r,
                                    best);
      const int cid = __ldg(node_meta + 2 * base + page_nodes + n);
      n = __ldg(links + 16 * base +
                static_cast<size_t>(hit ? oct : 8 + oct) * page_nodes + n);
      if (hit && cid >= 0) {
        held = g * page_size + cid;
        break;
      }
    }
    const unsigned holders = __ballot_sync(kFull, held >= 0);
    if (holders == 0) return;
    const unsigned same = __match_any_sync(kFull, held);
    unsigned todo = holders;
    while (todo != 0) {
      const int leader = __ffs(todo) - 1;
      const unsigned group = __shfl_sync(kFull, same, leader);
      const int c = __shfl_sync(kFull, held, leader);
      WarpCluster wc;
      load_warp_cluster(wc, woop + static_cast<size_t>(c) * 4 * kWoopCols,
                        lane);
      if (kAnyHit) {
        if (warp_any_group(wc, group, r, best, lane)) {
          occluded = true;
          walking = false;
        }
      } else {
        warp_closest_group(wc, group, r, c, lane, best, best_slot);
      }
      todo &= ~group;
    }
  }
}

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
  paged_walk<false>(woop, node_box, node_meta, links, n_pages, page_size,
                    page_nodes, in_range && best > 0.0f, r, best, best_slot,
                    unused);
  if (in_range) {
    store_closest(i, best, best_slot, normal, mat, t_out, slot_out,
                  normal_out, mat_out);
  }
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r = {};
  float cap = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    cap = t_max[i];
  }
  int unused = -1;
  bool occluded = false;
  paged_walk<true>(woop, node_box, node_meta, links, n_pages, page_size,
                   page_nodes, in_range && cap > 0.0f, r, cap, unused,
                   occluded);
  if (in_range) occ_out[i] = occluded;
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
