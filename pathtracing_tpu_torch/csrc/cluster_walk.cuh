// The warp-cooperative cluster-tree walker and the two kernel bodies on
// it, shared by every traversal kernel that walks a tree: both kernels of
// flat scenes (cluster_trace.cu), of paged scenes (cluster_trace_paged.cu),
// of the tree route past the flat budget (cluster_trace_tree.cu: the
// closest hit and any hit over the unpaged set's tree, and the closest hit
// over each page's tree) and of two-level instanced scenes
// (cluster_trace_inst_tree.cu).
//
// A tree is a threaded binary tree over cluster boxes (ops/clusters.py
// build_cluster_tree, build_octant_trees): node_box (6, N) [xyz min, xyz
// max], node_meta (2, N) [skip, cluster id or -1], links (16, N) [hit
// links of octants 0..7, then miss links]. A paged scene has one tree per
// page, stacked (G, 6, Np), (G, 2, Np), (G, 16, Np), with page-local leaf
// ids; a flat set has one, with the set's own ids.
//
// Each lane walks its own ray along its direction octant's links: slab
// test of the node's box against the ray's best t, then next = hit ?
// hit_link[oct][n] : miss_link[oct][n] until n passes the last node. A
// lane that reaches a leaf it pierces holds it and waits; when every lane
// of the warp holds a leaf or has finished, the warp evaluates the held
// pairs together (warp_closest_group / warp_any_group in
// cluster_common.cuh): lanes holding one cluster are grouped with
// __match_any_sync and share its coalesced Woop loads, each pair takes 32
// lanes of four triangles, and the (t, index) reduction keeps the smallest
// index on a tie, as the plain version does. Holding one leaf at a time
// keeps each ray's sequence of leaves and caps that of the plain walk
// (cluster_trace._walk_torch), so with --fmad=false the result equals it
// bit for bit. The any hit retires a lane at its first occluding cluster.
//
// kPaged: the lane visits its pages nearest first, in the order of their
// root boxes' entry distances (sorted by selection, ties by page index),
// and stops at the first page it enters no earlier than its best t; leaf
// ids become g * page_size + cid. Without pages there is no page loop: the
// lane walks the one tree from node 0 (n_pages and page_size unused), and
// the leaf id is the cluster id.
//
// Two levels (cluster_trace_inst_tree.cu): warp_walk takes a level policy
// whose step walks a tree over placement boxes in world space and, at a
// placement it pierces, the prototype's tree from the placement's root in
// its object space, both by walk_step; its leaves are evaluated with the
// lane's object-space ray. The default policy, OneLevel, is the walk
// above, and its hooks compile to nothing.
//
// Every lane of the warp must call the walker, dead and out-of-range lanes
// with live = false: its warp intrinsics name all 32 lanes.

#pragma once

#include "cluster_common.cuh"

namespace ptpu {

// Entry distance of a ray into a page's root box (column 0 of its (6,
// page_nodes) table), kBig when the ray misses the box: entry < best
// exactly when slab_strided passes against best.
__device__ __forceinline__ float page_entry(const float* root,
                                            int page_nodes, const Ray& r) {
  float tn, tf;
  slab_range(root, root + 3 * page_nodes, page_nodes, r, tn, tf);
  return (tn <= tf && tf > kTMin) ? tn : kBig;
}

// One step of a lane's walk: choose its next page (kPaged, between
// pages), or slab-test its next node and move along its octant's links.
// Sets `held` to the global id of a pierced leaf, or `walking` to false
// when the lane has no node left to visit.
template <bool kPaged>
__device__ __forceinline__ void walk_step(
    const float* __restrict__ node_box, const int* __restrict__ node_meta,
    const int* __restrict__ links, int n_pages, int page_size,
    int page_nodes, const Ray& r, int oct, float best, int& g, int& n,
    float& last_e, int& last_g, bool& walking, int& held) {
  if (kPaged && g < 0) {
    // The next page in (entry, index) order after the last one.
    float next_e = __int_as_float(0x7f800000);  // +inf
    int next_g = -1;
    for (int p = 0; p < n_pages; ++p) {
      const float e = page_entry(
          node_box + static_cast<size_t>(p) * 6 * page_nodes, page_nodes, r);
      const bool later = e > last_e || (e == last_e && p > last_g);
      if (later && e < next_e) {
        next_e = e;
        next_g = p;
      }
    }
    // Pages come nearest first: none after this one can be entered.
    if (next_g < 0 || !(next_e < best)) {
      walking = false;
      return;
    }
    g = next_g;
    n = 0;
    last_e = next_e;
    last_g = next_g;
  }
  if (n >= page_nodes) {
    if (kPaged) {
      g = -1;
    } else {
      walking = false;
    }
    return;
  }
  const size_t base = static_cast<size_t>(g) * page_nodes;
  const bool hit = slab_strided(node_box + 6 * base + n, page_nodes, r, best);
  const int cid = __ldg(node_meta + 2 * base + page_nodes + n);
  n = __ldg(links + 16 * base +
            static_cast<size_t>(hit ? oct : 8 + oct) * page_nodes + n);
  if (hit && cid >= 0) held = kPaged ? g * page_size + cid : cid;
}

// The level policy of a one-level walk, warp_walk's default: the lane's
// steps are walk_step's, its leaves are evaluated with its own ray, and a
// win records nothing. A two-level policy sets kTwoLevel, steps with
// step(node_box, node_meta, links, page_nodes, r, oct, best, walking,
// held) and gives the ray its leaves are evaluated with (ray) and what a
// win records (won).
struct OneLevel {
  static constexpr bool kTwoLevel = false;
  static __device__ __forceinline__ const Ray& ray(const OneLevel*,
                                                   const Ray& r) {
    return r;
  }
  static __device__ __forceinline__ void won(OneLevel*) {}
};

// The warp walks its lanes' rays through the tree or pages (see the note
// above), or through two levels under a two-level policy `level`. Closest
// hit: updates best and best_slot. kAnyHit: best is the fixed cap and
// `occluded` is set at the first hit.
//
// The warp steps together: the stepping loop ends on a warp vote, once
// every lane holds a leaf or has finished. A loop that each lane left on
// its own condition (while (walking) { ... break; }) let ptxas (CUDA
// 12.8, -O3) fold it into the outer loop for the any hit of a flat tree,
// so that the ballot below ran with only the lanes that had just found a
// leaf and the others' occluders were missed.
template <bool kPaged, bool kAnyHit, class Level = OneLevel>
__device__ __forceinline__ void warp_walk(
    const float* __restrict__ woop, const float* __restrict__ node_box,
    const int* __restrict__ node_meta, const int* __restrict__ links,
    int n_pages, int page_size, int page_nodes, bool live, const Ray& r,
    float& best, int& best_slot, bool& occluded, Level* level = nullptr) {
  const int lane = threadIdx.x % kWarp;
  const int oct = octant(r);
  bool walking = live;
  int g = kPaged ? -1 : 0;      // page being walked, -1 between pages
  int n = 0;                    // its next node
  float last_e = -kBig;         // entry and index of the page walked last
  int last_g = -1;              // (every page comes after these)
  for (;;) {
    int held = -1;              // global id of the leaf this lane holds
    while (__any_sync(kFull, walking && held < 0)) {
      if (walking && held < 0) {
        if constexpr (Level::kTwoLevel) {
          level->step(node_box, node_meta, links, page_nodes, r, oct, best,
                      walking, held);
        } else {
          walk_step<kPaged>(node_box, node_meta, links, n_pages, page_size,
                            page_nodes, r, oct, best, g, n, last_e, last_g,
                            walking, held);
        }
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
      const Ray& q = Level::ray(level, r);
      if (kAnyHit) {
        if (warp_any_group(wc, group, q, best, lane)) {
          occluded = true;
          walking = false;
        }
      } else if (warp_closest_group(wc, group, q, c, lane, best,
                                    best_slot)) {
        Level::won(level);
      }
      todo &= ~group;
    }
  }
}

// The body of a closest-hit kernel on the walker, for ray i = blockIdx.x *
// blockDim.x + threadIdx.x: load the ray and its t_init, walk, write (t,
// slot, normal, mat). Lanes past n_rays and dead lanes (t_init <= 0) walk
// with live = false and store nothing past n_rays. kWoopNormal: the normal
// is the winner's Woop w-row (store_tree_hit, the tree kernels; `normal` is
// not read); otherwise normal and material come from the cluster tables
// (store_closest).
template <bool kPaged, bool kWoopNormal>
__device__ __forceinline__ void closest_hit_walk(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_init, const float* __restrict__ woop,
    const float* __restrict__ normal, const int* __restrict__ mat,
    const float* __restrict__ node_box, const int* __restrict__ node_meta,
    const int* __restrict__ links, int n_rays, int n_pages, int page_size,
    int page_nodes, float* __restrict__ t_out, int* __restrict__ slot_out,
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
  warp_walk<kPaged, false>(woop, node_box, node_meta, links, n_pages,
                           page_size, page_nodes, in_range && best > 0.0f,
                           r, best, best_slot, unused);
  if (in_range && kWoopNormal) {
    store_tree_hit(i, best, best_slot, woop, mat, t_out, slot_out,
                   normal_out, mat_out);
  } else if (in_range) {
    store_closest(i, best, best_slot, normal, mat, t_out, slot_out,
                  normal_out, mat_out);
  }
}

// The body of an any-hit kernel on the walker, for ray i as above: the cap
// t_max stays fixed and occ_out[i] is whether some triangle lies strictly
// inside (T_MIN, cap). Lanes past n_rays and dead lanes (t_max <= 0) walk
// with live = false; a dead lane is not occluded.
template <bool kPaged>
__device__ __forceinline__ void any_hit_walk(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, const float* __restrict__ woop,
    const float* __restrict__ node_box, const int* __restrict__ node_meta,
    const int* __restrict__ links, int n_rays, int n_pages, int page_size,
    int page_nodes, bool* __restrict__ occ_out) {
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
  warp_walk<kPaged, true>(woop, node_box, node_meta, links, n_pages,
                          page_size, page_nodes, in_range && cap > 0.0f, r,
                          cap, unused, occluded);
  if (in_range) occ_out[i] = occluded;
}

}  // namespace ptpu
