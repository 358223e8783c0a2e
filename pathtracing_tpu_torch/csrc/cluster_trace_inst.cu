// Instanced cluster-sweep traversal kernels for Hopper (sm_90a): closest
// hit and any-hit of rays against shared prototype clusters placed by
// per-instance affine transforms (ops/clusters.py: InstanceSet).
//
// Replaces the TPU kernels of the JAX package:
//   trace_dnf_inst_kernel    <- pathtracing_tpu/ops/cluster_trace.py
//                               trace_pallas_dnf_inst (_tile_kernel_dnf_inst)
//   occluded_dnf_inst_kernel <- pathtracing_tpu/ops/cluster_trace.py
//                               occluded_pallas_dnf_inst (same kernel, occ)
// under the same contract: the sweep runs over EXPANDED world-space boxes,
// one per (instance, prototype cluster) pair; a ray that pierces box e goes
// into the object space of prototype cluster cmap[e] by 12 scalars
// (o' = tr + L o, d' = L d with L the inverse of the instance's affine, so
// t keeps its world parameterization) and is tested against that cluster's
// 128 Woop triangles. slot = cmap[e]*128 + lane is a PROTOTYPE slot; the
// winning e also picks the transform that takes the table's object-space
// normal to world space (L^T n, renormalised) and the per-instance material
// override imat[e] (>= 0 replaces the triangle's material). With motion
// (fw0/fw1 given) the forward affine is lerped at the ray's shutter time and
// inverted by adjugate per (ray, pierced cluster). t_init / t_max <= 0
// marks a dead lane; a miss returns slot -1, normal 0, mat 0, t passed on.
//
// What bounds it on this card: operations, as for the flat kernels. Each
// pierced (ray, expanded cluster) pair costs the transform (30 float
// operations static, about 130 with motion) beside 128 x 48 for the Woop
// pass, all float32 on the CUDA cores: the tensor cores stay out, since the
// Woop tests must round as the plain version does and TF32 breaks
// geometry. The bytes are small: the prototype tables (7.7 KB per
// prototype cluster) and 72 B per expanded cluster (168 B with motion)
// stay in L2.
//
// Design of the closest hit (trace_dnf_inst_kernel). The expanded clusters
// of one placement (the base geometry, or one instance) are contiguous, so
// InstanceSet carries a box per placement, the union of its expanded
// boxes (inst_first, inst_min, inst_max). The sweep has two levels: the
// block stages the placement boxes in shared memory (1024 at a time, 24
// KB), a warp enters a placement only where one of its live lanes pierces
// that box against the lane's best t, and then slab-tests the placement's
// expanded boxes from global memory (broadcast loads). The culling is
// exact: every expanded box lies inside its placement's box and the slab
// test's rounding is monotone, so a pair that passes its own box passes
// its placement's, and the kernel evaluates the same pairs in the same
// (index) order as trace_inst_torch. Each pierced pair is evaluated by the
// whole warp: every lane that pierces expanded cluster e takes the ray into
// e's object space itself (load_xform, to_object), the warp loads the
// prototype cluster's Woop rows once, coalesced, four triangles a lane,
// and evaluates those lanes' rays one after another, broadcast with
// __shfl_sync (warp_closest_group in cluster_common.cuh), keeping the
// smallest triangle index on a tie as the serial scan does. Strict <
// across expanded clusters decides the instance (transform, override) as
// well as the slot. The motion inverse is recomputed per pierced pair and
// once more for the winner in the epilogue, from the same inputs in the
// same order, so it gives the same bits both times.
//
// Design of the any hit (occluded_dnf_inst_kernel). The first Hopper
// design swept every expanded box for every warp and tested a pierced
// pair's 128 triangles on one lane. Here the any hit takes the closest
// hit's two levels with its cap fixed: placement boxes staged in shared
// memory, a warp entering a placement only where a pending lane (live and
// not yet occluded) pierces its box, the placement's expanded boxes
// slab-tested from global memory, and each pierced pair evaluated by the
// whole warp (warp_any_group). A lane retires at its first occluding pair,
// and a warp leaves a chunk of placements once no lane is pending; every
// warp still reaches each chunk's two barriers. The culling is exact as
// above, so the kernel evaluates a subset of occluded_inst_torch's pairs:
// every pair that could occlude a ray before its first occluder. Whether
// some triangle lies strictly inside (T_MIN, cap) does not depend on the
// order of visits, so the bool equals the index-order sweep's.
//
// Formula order follows _ray_to_object and _lerp_affine_inverse of
// ops/cluster_trace.py term by term, and the build uses --fmad=false, so
// an identity instance passes a ray through bit for bit and t, slot, mat
// and the normal equal the plain version's on the card.

#include "cluster_common.cuh"

using namespace ptpu;

namespace {

// The 12 world->object scalars [L00..L22 row-major, tr0..tr2] of expanded
// cluster e: read from `xform`, or with motion the adjugate inverse of the
// forward affine f0 + tt (f1 - f0) (_lerp_affine_inverse).
template <bool kMotion>
__device__ __forceinline__ void load_xform(float* xf,
                                           const float* __restrict__ xform,
                                           const float* __restrict__ fw0,
                                           const float* __restrict__ fw1,
                                           int e, float tt) {
  if constexpr (!kMotion) {
#pragma unroll
    for (int j = 0; j < 12; ++j) xf[j] = __ldg(xform + 12 * e + j);
  } else {
    float a[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float f0 = __ldg(fw0 + 12 * e + j);
      const float f1 = __ldg(fw1 + 12 * e + j);
      a[j] = f0 + tt * (f1 - f0);
    }
    const float c00 = a[4] * a[8] - a[5] * a[7];
    const float c01 = a[2] * a[7] - a[1] * a[8];
    const float c02 = a[1] * a[5] - a[2] * a[4];
    const float c10 = a[5] * a[6] - a[3] * a[8];
    const float c11 = a[0] * a[8] - a[2] * a[6];
    const float c12 = a[2] * a[3] - a[0] * a[5];
    const float c20 = a[3] * a[7] - a[4] * a[6];
    const float c21 = a[1] * a[6] - a[0] * a[7];
    const float c22 = a[0] * a[4] - a[1] * a[3];
    float det = a[0] * c00;
    det = det + a[1] * c10;
    det = det + a[2] * c20;
    const float guarded =
        fabsf(det) < 1e-30f ? (det < 0.0f ? -1e-30f : 1e-30f) : det;
    const float inv = 1.0f / guarded;
    xf[0] = c00 * inv;
    xf[1] = c01 * inv;
    xf[2] = c02 * inv;
    xf[3] = c10 * inv;
    xf[4] = c11 * inv;
    xf[5] = c12 * inv;
    xf[6] = c20 * inv;
    xf[7] = c21 * inv;
    xf[8] = c22 * inv;
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      float s = xf[3 * row] * a[9];
      s = s + xf[3 * row + 1] * a[10];
      s = s + xf[3 * row + 2] * a[11];
      xf[9 + row] = -s;
    }
  }
}

template <bool kMotion>
__global__ void __launch_bounds__(kBlock)
trace_dnf_inst_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const float* __restrict__ t_init,
                      const float* __restrict__ time,
                      const float* __restrict__ aabb_min,
                      const float* __restrict__ aabb_max,
                      const int* __restrict__ cmap,
                      const float* __restrict__ xform,
                      const int* __restrict__ imat,
                      const float* __restrict__ fw0,
                      const float* __restrict__ fw1,
                      const int* __restrict__ inst_first,
                      const float* __restrict__ inst_min,
                      const float* __restrict__ inst_max,
                      const float* __restrict__ woop,
                      const float* __restrict__ normal,
                      const int* __restrict__ mat, int n_rays, int n_inst,
                      float* __restrict__ t_out, int* __restrict__ slot_out,
                      float* __restrict__ normal_out,
                      int* __restrict__ mat_out) {
  __shared__ float box[6][kBoxChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp_lane = threadIdx.x % kWarp;
  const bool in_range = i < n_rays;
  Ray r = {};
  float best = 0.0f;
  float tt = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    best = t_init[i];
    if (kMotion) tt = time[i];
  }
  const bool live = in_range && best > 0.0f;
  int best_slot = -1;
  int best_e = 0;

  if (__syncthreads_or(live)) {
    for (int p0 = 0; p0 < n_inst; p0 += kBoxChunk) {
      const int n = min(kBoxChunk, n_inst - p0);
      __syncthreads();
      stage_boxes(box, inst_min, inst_max, p0, n);
      __syncthreads();
      if (!__any_sync(kFull, live)) continue;
      for (int k = 0; k < n; ++k) {
        const bool in = live && slab(box, k, r, best);
        if (!__any_sync(kFull, in)) continue;
        const int e_end = __ldg(inst_first + p0 + k + 1);
        for (int e = __ldg(inst_first + p0 + k); e < e_end; ++e) {
          const bool h =
              in && slab_test(aabb_min + 3 * e, aabb_max + 3 * e, 1, r, best);
          const unsigned group = __ballot_sync(kFull, h);
          if (group == 0) continue;
          Ray q = {};
          if (h) {
            float xf[12];
            load_xform<kMotion>(xf, xform, fw0, fw1, e, tt);
            q = to_object(xf, r);
          }
          const int p = __ldg(cmap + e);
          WarpCluster wc;
          load_warp_cluster(wc, woop + static_cast<size_t>(p) * 4 * kWoopCols,
                            warp_lane);
          if (warp_closest_group(wc, group, q, p, warp_lane, best,
                                 best_slot)) {
            best_e = e;
          }
        }
      }
    }
  }
  if (!in_range) return;
  t_out[i] = best;
  slot_out[i] = best_slot;
  if (best_slot < 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) normal_out[3 * i + a] = 0.0f;
    mat_out[i] = 0;
    return;
  }
  const int p = best_slot / kClusterSize;
  const int lane = best_slot % kClusterSize;
  const float* nc = normal + static_cast<size_t>(p) * 3 * kClusterSize;
  const float n0 = nc[lane];
  const float n1 = nc[kClusterSize + lane];
  const float n2 = nc[2 * kClusterSize + lane];
  float xf[12];
  load_xform<kMotion>(xf, xform, fw0, fw1, best_e, tt);
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
  int m = mat[static_cast<size_t>(p) * kClusterSize + lane];
  if (imat != nullptr) {
    const int im = imat[best_e];
    if (im >= 0) m = im;
  }
  mat_out[i] = m;
}

template <bool kMotion>
__global__ void __launch_bounds__(kBlock)
occluded_dnf_inst_kernel(const float* __restrict__ origin,
                         const float* __restrict__ direction,
                         const float* __restrict__ t_max,
                         const float* __restrict__ time,
                         const float* __restrict__ aabb_min,
                         const float* __restrict__ aabb_max,
                         const int* __restrict__ cmap,
                         const float* __restrict__ xform,
                         const float* __restrict__ fw0,
                         const float* __restrict__ fw1,
                         const int* __restrict__ inst_first,
                         const float* __restrict__ inst_min,
                         const float* __restrict__ inst_max,
                         const float* __restrict__ woop, int n_rays,
                         int n_inst, bool* __restrict__ occ_out) {
  __shared__ float box[6][kBoxChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp_lane = threadIdx.x % kWarp;
  const bool in_range = i < n_rays;
  Ray r = {};
  float cap = 0.0f;
  float tt = 0.0f;
  if (in_range) {
    r = load_ray(origin, direction, i);
    cap = t_max[i];
    if (kMotion) tt = time[i];
  }
  bool pending = in_range && cap > 0.0f;  // live and not yet occluded
  bool occ = false;

  if (__syncthreads_or(pending)) {
    for (int p0 = 0; p0 < n_inst; p0 += kBoxChunk) {
      const int n = min(kBoxChunk, n_inst - p0);
      __syncthreads();
      stage_boxes(box, inst_min, inst_max, p0, n);
      __syncthreads();
      // Only this loop may end early: every warp must reach the next
      // chunk's barriers.
      for (int k = 0; k < n; ++k) {
        if (!__any_sync(kFull, pending)) break;  // whole warp finished
        const bool in = pending && slab(box, k, r, cap);
        if (!__any_sync(kFull, in)) continue;
        const int e_end = __ldg(inst_first + p0 + k + 1);
        for (int e = __ldg(inst_first + p0 + k); e < e_end; ++e) {
          const bool h = in && pending &&
                         slab_test(aabb_min + 3 * e, aabb_max + 3 * e, 1, r,
                                   cap);
          const unsigned group = __ballot_sync(kFull, h);
          if (group == 0) continue;
          Ray q = {};
          if (h) {
            float xf[12];
            load_xform<kMotion>(xf, xform, fw0, fw1, e, tt);
            q = to_object(xf, r);
          }
          const int p = __ldg(cmap + e);
          WarpCluster wc;
          load_warp_cluster(wc, woop + static_cast<size_t>(p) * 4 * kWoopCols,
                            warp_lane);
          if (warp_any_group(wc, group, q, cap, warp_lane)) {
            occ = true;
            pending = false;
          }
          if (!__any_sync(kFull, pending)) break;
        }
      }
    }
  }
  if (in_range) occ_out[i] = occ;
}

}  // namespace

extern "C" {

// `time`, `fw0` and `fw1` are all null (static instances) or all given
// (motion); `imat` may be null (no overrides). `inst_first` (n_inst + 1)
// bounds each placement's run of expanded clusters, `inst_min` /
// `inst_max` (n_inst, 3) its box; both kernels take them.
int ptpu_trace_dnf_inst(const float* origin, const float* direction,
                        const float* t_init, const float* time,
                        const float* aabb_min, const float* aabb_max,
                        const int* cmap, const float* xform, const int* imat,
                        const float* fw0, const float* fw1,
                        const int* inst_first, const float* inst_min,
                        const float* inst_max, const float* woop,
                        const float* normal, const int* mat, int n_rays,
                        int n_inst, float* t_out, int* slot_out,
                        float* normal_out, int* mat_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fw0 != nullptr) {
    trace_dnf_inst_kernel<true><<<grid, kBlock, 0, s>>>(
        origin, direction, t_init, time, aabb_min, aabb_max, cmap, xform,
        imat, fw0, fw1, inst_first, inst_min, inst_max, woop, normal, mat,
        n_rays, n_inst, t_out, slot_out, normal_out, mat_out);
  } else {
    trace_dnf_inst_kernel<false><<<grid, kBlock, 0, s>>>(
        origin, direction, t_init, time, aabb_min, aabb_max, cmap, xform,
        imat, fw0, fw1, inst_first, inst_min, inst_max, woop, normal, mat,
        n_rays, n_inst, t_out, slot_out, normal_out, mat_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int ptpu_occluded_dnf_inst(const float* origin, const float* direction,
                           const float* t_max, const float* time,
                           const float* aabb_min, const float* aabb_max,
                           const int* cmap, const float* xform,
                           const float* fw0, const float* fw1,
                           const int* inst_first, const float* inst_min,
                           const float* inst_max, const float* woop,
                           int n_rays, int n_inst, bool* occ_out,
                           void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fw0 != nullptr) {
    occluded_dnf_inst_kernel<true><<<grid, kBlock, 0, s>>>(
        origin, direction, t_max, time, aabb_min, aabb_max, cmap, xform,
        fw0, fw1, inst_first, inst_min, inst_max, woop, n_rays, n_inst,
        occ_out);
  } else {
    occluded_dnf_inst_kernel<false><<<grid, kBlock, 0, s>>>(
        origin, direction, t_max, time, aabb_min, aabb_max, cmap, xform,
        fw0, fw1, inst_first, inst_min, inst_max, woop, n_rays, n_inst,
        occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
