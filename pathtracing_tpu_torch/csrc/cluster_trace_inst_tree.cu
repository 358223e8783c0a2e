// Two-level instanced traversal kernels for Hopper (sm_90a): closest hit
// and any hit of rays against prototypes stored once and placed by affine
// transforms, through a tree over the placements' world boxes above each
// prototype's own cluster tree (ops/clusters.py: InstanceTree). No TPU
// kernel corresponds: the JAX package sweeps expanded (placement,
// prototype cluster) boxes (cluster_trace_inst.cu's kernels), whose number
// is the product of placements and prototype clusters; here the tables
// grow with their sum.
//
//   trace_inst_tree_kernel     closest hit: (t, slot, normal, mat)
//   occluded_inst_tree_kernel  any hit: whether some triangle lies
//                              strictly inside (T_MIN, t_max)
//
// Design. Both kernels are the shared walker (cluster_walk.cuh warp_walk)
// under the two-level policy TwoLevel below. Each lane walks its world ray
// along its octant's links of the top tree over the placement boxes
// (walk_step, as a flat tree); at a placement leaf it pierces before its
// best t it enters the placement: it takes its ray into the placement's
// object space (to_object, _ray_to_object's formula and term order, with
// the reciprocals and octant of the new direction) and walks the
// prototype's cluster tree in the forest from the placement's root
// (walk_step again, along the object ray's octant). A prototype leaf it
// pierces is held as in a flat walk: the warp evaluates the held leaves
// together with warp_closest_group / warp_any_group, each lane's object
// ray broadcast, so lanes in different placements of one prototype share
// a cluster's coalesced Woop loads. When the prototype's walk ends the
// lane goes back to the top tree with its world ray. t is the world t
// throughout (the affine move keeps the ray's parameterization), so a
// lane's best t culls both levels. The closest hit keeps the placement of
// its best hit; its normal is L^T n of the table's object-space normal,
// renormalised, and the placement's override replaces the material. The
// any hit retires a lane at its first occluder. Each lane visits the same
// leaves in the same order as the plain walk (cluster_trace.py
// _walk_inst_torch), and with --fmad=false the results equal it bit for
// bit.
//
// Counting (kCount, the engine's traced frames only): each lane counts the
// placements it enters and the prototype leaves it holds for evaluation,
// as the plain walk counts them; the warp sums both and one lane adds
// them to counts[0] and counts[1] with one atomic add each. The other
// instantiation counts nothing.
//
// What bounds it on this card: operations, as for the flat walks. A
// placement entered costs its transform (30 float operations and 3
// reciprocals) beside the slab tests of both trees and 128 x 48 per
// evaluated prototype cluster; the tables (7.7 KB a prototype cluster,
// 48 B a placement record, 96 B a tree node) mostly stay in L2.

#include "cluster_walk.cuh"

using namespace ptpu;

namespace {

// The two-level policy of warp_walk (see the note above): the top tree,
// the placements' transforms and roots, and one lane's walk; with kCount
// also the lane's counts.
template <bool kCount>
struct TwoLevel {
  static constexpr bool kTwoLevel = true;
  const float* __restrict__ top_box;
  const int* __restrict__ top_meta;
  const int* __restrict__ top_links;
  int top_nodes;
  const float* __restrict__ xform;
  const int* __restrict__ root;
  int tn = 0;          // next node of the top tree
  int p = -1;          // placement being walked; -1 at the top level
  int n = 0;           // its next forest node
  Ray q = {};          // the ray in p's object space
  int q_oct = 0;
  int best_p = 0;      // placement of the best hit
  unsigned entered = 0;  // placements entered (kCount)
  unsigned tested = 0;   // prototype leaves held (kCount)

  __device__ __forceinline__ void enter(int pid, const Ray& r) {
    float xf[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) xf[j] = __ldg(xform + 12 * pid + j);
    q = to_object(xf, r);
#pragma unroll
    for (int a = 0; a < 3; ++a) q.inv[a] = safe_inv(q.d[a]);
    q_oct = octant(q);
    n = __ldg(root + pid);
    p = pid;
    if constexpr (kCount) ++entered;
  }

  // One step: of the top tree (entering a pierced placement), or of the
  // placement's prototype tree (holding a pierced leaf; back to the top
  // level once that tree ends). `walking` ends with the top tree.
  __device__ __forceinline__ void step(const float* __restrict__ forest_box,
                                       const int* __restrict__ forest_meta,
                                       const int* __restrict__ forest_links,
                                       int forest_nodes, const Ray& r,
                                       int oct, float best, bool& walking,
                                       int& held) {
    int g = 0;             // one tree per level: no pages
    float last_e = 0.0f;
    int last_g = 0;
    if (p < 0) {
      int pid = -1;
      walk_step<false>(top_box, top_meta, top_links, 0, 0, top_nodes, r, oct,
                       best, g, tn, last_e, last_g, walking, pid);
      if (pid >= 0) enter(pid, r);
      return;
    }
    bool inside = true;
    walk_step<false>(forest_box, forest_meta, forest_links, 0, 0,
                     forest_nodes, q, q_oct, best, g, n, last_e, last_g,
                     inside, held);
    if constexpr (kCount) tested += held >= 0;
    if (!inside) p = -1;
  }

  static __device__ __forceinline__ const Ray& ray(const TwoLevel* s,
                                                   const Ray&) {
    return s->q;
  }
  static __device__ __forceinline__ void won(TwoLevel* s) { s->best_p = s->p; }

  // The warp's sums of the lanes' counts, added by lane 0. Every lane of
  // the warp calls it.
  __device__ __forceinline__ void add_counts(unsigned long long* counts) {
    if constexpr (kCount) {
      const unsigned e = __reduce_add_sync(kFull, entered);
      const unsigned t = __reduce_add_sync(kFull, tested);
      if (threadIdx.x % kWarp == 0) {
        atomicAdd(counts, static_cast<unsigned long long>(e));
        atomicAdd(counts + 1, static_cast<unsigned long long>(t));
      }
    }
  }
};

template <bool kCount>
__global__ void __launch_bounds__(kBlock)
trace_inst_tree_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_init,
                       const float* __restrict__ top_box,
                       const int* __restrict__ top_meta,
                       const int* __restrict__ top_links,
                       const float* __restrict__ xform,
                       const int* __restrict__ root,
                       const int* __restrict__ imat,
                       const float* __restrict__ forest_box,
                       const int* __restrict__ forest_meta,
                       const int* __restrict__ forest_links,
                       const float* __restrict__ woop,
                       const float* __restrict__ normal,
                       const int* __restrict__ mat, int n_rays, int n_top,
                       int n_forest, float* __restrict__ t_out,
                       int* __restrict__ slot_out,
                       float* __restrict__ normal_out,
                       int* __restrict__ mat_out,
                       unsigned long long* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r = {};
  float best = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    best = t_init[i];
  }
  TwoLevel<kCount> lv;
  lv.top_box = top_box;
  lv.top_meta = top_meta;
  lv.top_links = top_links;
  lv.top_nodes = n_top;
  lv.xform = xform;
  lv.root = root;
  int best_slot = -1;
  bool unused = false;
  warp_walk<false, false>(woop, forest_box, forest_meta, forest_links, 0, 0,
                          n_forest, in_range && best > 0.0f, r, best,
                          best_slot, unused, &lv);
  lv.add_counts(counts);
  if (!in_range) return;
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
  const float* nc = normal + static_cast<size_t>(c) * 3 * kClusterSize;
  const float n0 = nc[lane];
  const float n1 = nc[kClusterSize + lane];
  const float n2 = nc[2 * kClusterSize + lane];
  const float* xf = xform + 12 * lv.best_p;
  // World normal = L^T n (rows of L^T are columns of L), renormalised.
  float nw[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float s = xf[a] * n0;
    s = s + xf[3 + a] * n1;
    s = s + xf[6 + a] * n2;
    nw[a] = s;
  }
  float len2 = nw[0] * nw[0];
  len2 = len2 + nw[1] * nw[1];
  len2 = len2 + nw[2] * nw[2];
  const float inv_len = rsqrtf(fmaxf(len2, 1e-30f));
#pragma unroll
  for (int a = 0; a < 3; ++a) normal_out[3 * i + a] = nw[a] * inv_len;
  int m = mat[static_cast<size_t>(c) * kClusterSize + lane];
  if (imat != nullptr) {
    const int im = imat[lv.best_p];
    if (im >= 0) m = im;
  }
  mat_out[i] = m;
}

template <bool kCount>
__global__ void __launch_bounds__(kBlock)
occluded_inst_tree_kernel(const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const float* __restrict__ t_max,
                          const float* __restrict__ top_box,
                          const int* __restrict__ top_meta,
                          const int* __restrict__ top_links,
                          const float* __restrict__ xform,
                          const int* __restrict__ root,
                          const float* __restrict__ forest_box,
                          const int* __restrict__ forest_meta,
                          const int* __restrict__ forest_links,
                          const float* __restrict__ woop, int n_rays,
                          int n_top, int n_forest,
                          bool* __restrict__ occ_out,
                          unsigned long long* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r = {};
  float cap = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    cap = t_max[i];
  }
  TwoLevel<kCount> lv;
  lv.top_box = top_box;
  lv.top_meta = top_meta;
  lv.top_links = top_links;
  lv.top_nodes = n_top;
  lv.xform = xform;
  lv.root = root;
  int unused = -1;
  bool occluded = false;
  warp_walk<false, true>(woop, forest_box, forest_meta, forest_links, 0, 0,
                         n_forest, in_range && cap > 0.0f, r, cap, unused,
                         occluded, &lv);
  lv.add_counts(counts);
  if (in_range) occ_out[i] = occluded;
}

}  // namespace

extern "C" {

// `imat` may be null (no overrides). `counts` may be null (no counting);
// otherwise two int64s the launch adds its placements entered and
// prototype leaves tested to.
int ptpu_trace_inst_tree(const float* origin, const float* direction,
                         const float* t_init, const float* top_box,
                         const int* top_meta, const int* top_links,
                         const float* xform, const int* root, const int* imat,
                         const float* forest_box, const int* forest_meta,
                         const int* forest_links, const float* woop,
                         const float* normal, const int* mat, int n_rays,
                         int n_top, int n_forest, float* t_out, int* slot_out,
                         float* normal_out, int* mat_out,
                         unsigned long long* counts, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  auto* kernel = counts != nullptr ? trace_inst_tree_kernel<true>
                                   : trace_inst_tree_kernel<false>;
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_init, top_box, top_meta, top_links, xform, root,
      imat, forest_box, forest_meta, forest_links, woop, normal, mat, n_rays,
      n_top, n_forest, t_out, slot_out, normal_out, mat_out, counts);
  return static_cast<int>(cudaGetLastError());
}

int ptpu_occluded_inst_tree(const float* origin, const float* direction,
                            const float* t_max, const float* top_box,
                            const int* top_meta, const int* top_links,
                            const float* xform, const int* root,
                            const float* forest_box, const int* forest_meta,
                            const int* forest_links, const float* woop,
                            int n_rays, int n_top, int n_forest,
                            bool* occ_out, unsigned long long* counts,
                            void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  auto* kernel = counts != nullptr ? occluded_inst_tree_kernel<true>
                                   : occluded_inst_tree_kernel<false>;
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, t_max, top_box, top_meta, top_links, xform, root,
      forest_box, forest_meta, forest_links, woop, n_rays, n_top, n_forest,
      occ_out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
