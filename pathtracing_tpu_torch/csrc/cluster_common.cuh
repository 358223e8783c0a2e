// Shared device helpers of the cluster traversal kernels
// (cluster_trace.cu: flat scenes; cluster_trace_inst.cu: instanced scenes;
// cluster_trace_inst_tree.cu: two-level instanced scenes;
// cluster_trace_paged.cu: paged scenes; cluster_trace_tree.cu: the
// cluster-tree walks): the ray record, the safe reciprocal, the direction
// octant, the shared-memory box staging, the slab test, the Woop triangle
// test, a ray's move into an instance's object space, the closest hit and
// any hit of rays within one cluster on the whole warp, and the two
// epilogues of a closest hit (normal from the cluster table, or from the
// winner's Woop w-row). The tree walker is in
// cluster_walk.cuh. Every multiply and add is written in the order of the
// plain torch versions (ops/cluster_trace.py: _slab, _pair_eval) and the
// sources are built with --fmad=false, so a kernel's t equals its plain
// version's bit for bit. The Woop tests are float32 multiply-adds on the
// CUDA cores: a tensor-core product would round through TF32, which breaks
// geometry.

#pragma once

#include <cuda_runtime.h>

namespace ptpu {

constexpr int kClusterSize = 128;
constexpr int kWoopCols = 3 * kClusterSize;
constexpr int kBoxChunk = 1024;
constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;
constexpr float kTMin = 1e-3f;

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
};

__device__ __forceinline__ float safe_inv(float d) {
  const float dd = fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d;
  return 1.0f / dd;
}

__device__ __forceinline__ Ray load_ray(const float* origin,
                                        const float* direction, int i) {
  Ray r = {};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = origin[3 * i + a];
    r.d[a] = direction[3 * i + a];
    r.inv[a] = safe_inv(r.d[a]);
  }
  return r;
}

// Direction octant of a ray, the layout of the trees' octant links: x>0 ->
// +4, y>0 -> +2, z>0 -> +1 (a zero component counts as negative).
__device__ __forceinline__ int octant(const Ray& r) {
  return (r.d[0] > 0.0f ? 4 : 0) + (r.d[1] > 0.0f ? 2 : 0) +
         (r.d[2] > 0.0f ? 1 : 0);
}

// Stage boxes [c0, c0 + n) into shared memory as box[axis][c - c0]
// (axis 0..2 = min, 3..5 = max).
__device__ __forceinline__ void stage_boxes(float (*box)[kBoxChunk],
                                            const float* aabb_min,
                                            const float* aabb_max, int c0,
                                            int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a][k] = aabb_min[3 * (c0 + k) + a];
      box[3 + a][k] = aabb_max[3 * (c0 + k) + a];
    }
  }
}

// Near and far distances (tn, tf) of a ray through one box whose axis-a
// bounds are lo[a * stride] and hi[a * stride].
__device__ __forceinline__ void slab_range(const float* lo, const float* hi,
                                           int stride, const Ray& r,
                                           float& tn, float& tf) {
  tn = -kBig;
  tf = kBig;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a * stride] - r.o[a]) * r.inv[a];
    const float t1 = (hi[a * stride] - r.o[a]) * r.inv[a];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
}

// Slab test of one box against a ray's best t (the plain versions' _slab).
__device__ __forceinline__ bool slab_test(const float* lo, const float* hi,
                                          int stride, const Ray& r,
                                          float best) {
  float tn, tf;
  slab_range(lo, hi, stride, r, tn, tf);
  return (tn <= tf) && (tf > kTMin) && (tn < best);
}

// Slab test of one box stored as six floats `stride` apart (xyz min, xyz
// max): shared-memory chunks and the trees' (6, N) node tables alike.
__device__ __forceinline__ bool slab_strided(const float* b, int stride,
                                             const Ray& r, float best) {
  return slab_test(b, b + 3 * stride, stride, r, best);
}

__device__ __forceinline__ bool slab(const float (*box)[kBoxChunk], int k,
                                     const Ray& r, float best) {
  return slab_strided(&box[0][k], kBoxChunk, r, best);
}

// The Woop data of one triangle: for each component (u, v, w) its four
// rows w0..w3.
struct WoopTri {
  float w[3][4];
};

// Triangle `j` of one cluster (w points at its (4, 384) tensor). Across
// the lanes of a warp that read j = lane + 32k, each of the twelve loads
// is one coalesced 128-byte access.
__device__ __forceinline__ WoopTri load_tri(const float* __restrict__ w,
                                            int j) {
  WoopTri tri;
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
#pragma unroll
    for (int row = 0; row < 4; ++row) {
      tri.w[comp][row] = __ldg(w + row * kWoopCols + comp * kClusterSize + j);
    }
  }
  return tri;
}

// Woop test of one triangle: t, or kBig when the ray misses it or the hit
// is not inside (T_MIN, cap). Operation order matches _pair_eval.
__device__ __forceinline__ float woop_test(const WoopTri& tri, const Ray& r,
                                           float cap) {
  float op[3];
  float dp[3];
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    const float* w = tri.w[comp];
    float o = w[3] + r.o[0] * w[0];
    o = o + r.o[1] * w[1];
    o = o + r.o[2] * w[2];
    float d = r.d[0] * w[0];
    d = d + r.d[1] * w[1];
    d = d + r.d[2] * w[2];
    op[comp] = o;
    dp[comp] = d;
  }
  const float dw = fabsf(dp[2]) < 1e-30f ? 1e-30f : dp[2];
  const float t = -op[2] / dw;
  const float u = op[0] + t * dp[0];
  const float v = op[1] + t * dp[1];
  const bool ok = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                  (t > kTMin) && (t < cap);
  return ok ? t : kBig;
}

// A ray in an instance's object space (_ray_to_object of
// ops/cluster_trace.py) by its 12 world->object scalars xf [L00..L22
// row-major, tr0..tr2]: o' = tr + L0 o0 + L1 o1 + L2 o2 added left to
// right, d' = L0 d0 + L1 d1 + L2 d2; t keeps its world parameterization.
// `inv` is not used by the Woop test and stays 0 (the two-level walk sets
// it for its slab tests).
__device__ __forceinline__ Ray to_object(const float* xf, const Ray& r) {
  Ray q = {};
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    float o = xf[9 + row] + xf[3 * row] * r.o[0];
    o = o + xf[3 * row + 1] * r.o[1];
    o = o + xf[3 * row + 2] * r.o[2];
    float d = xf[3 * row] * r.d[0];
    d = d + xf[3 * row + 1] * r.d[1];
    d = d + xf[3 * row + 2] * r.d[2];
    q.o[row] = o;
    q.d[row] = d;
  }
  return q;
}

// --- The whole warp on one (ray, cluster) pair -------------------------
// Lane l takes triangles l, l + 32, l + 64 and l + 96 of the cluster, so
// each Woop row load is one coalesced 128-byte access and the 128 tests
// take four steps instead of 128 on one lane. Every function here is
// called by all 32 lanes with warp-uniform arguments where noted.

constexpr int kWarp = 32;
constexpr int kTriPerLane = kClusterSize / kWarp;

struct WarpCluster {
  WoopTri tri[kTriPerLane];
};

__device__ __forceinline__ void load_warp_cluster(WarpCluster& wc,
                                                  const float* __restrict__ w,
                                                  int lane) {
#pragma unroll
  for (int k = 0; k < kTriPerLane; ++k) {
    wc.tri[k] = load_tri(w, lane + kWarp * k);
  }
}

// Lane `src`'s origin and direction (the Woop test reads no inverse).
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray q = {};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q.o[a] = __shfl_sync(kFull, r.o[a], src);
    q.d[a] = __shfl_sync(kFull, r.d[a], src);
  }
  return q;
}

// Closest hit of the warp-uniform ray q among the cluster's triangles,
// capped at the warp-uniform cap: on every lane the smallest t (kBig when
// none) and in `j_min` the smallest triangle index that reaches it. The
// five butterfly steps keep the smaller (t, index) pair, so the result is
// the plain version's (_closest_update: the smallest lane on a tie).
__device__ __forceinline__ float warp_closest(const WarpCluster& wc,
                                              const Ray& q, float cap,
                                              int lane, int& j_min) {
  float t_min = kBig;
  j_min = kClusterSize;
#pragma unroll
  for (int k = 0; k < kTriPerLane; ++k) {
    const float t = woop_test(wc.tri[k], q, cap);
    if (t < t_min) {
      t_min = t;
      j_min = lane + kWarp * k;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(kFull, t_min, off);
    const int j2 = __shfl_xor_sync(kFull, j_min, off);
    if (t2 < t_min || (t2 == t_min && j2 < j_min)) {
      t_min = t2;
      j_min = j2;
    }
  }
  return t_min;
}

// The warp evaluates cluster c (its triangles in wc) for each lane of the
// warp-uniform mask `group`, that lane's ray q broadcast and capped at its
// best (strict < across clusters, as the serial sweeps). Returns true on
// a lane whose best improved.
__device__ __forceinline__ bool warp_closest_group(const WarpCluster& wc,
                                                   unsigned group,
                                                   const Ray& q, int c,
                                                   int lane, float& best,
                                                   int& best_slot) {
  bool improved = false;
  while (group != 0) {
    const int m = __ffs(group) - 1;
    group &= group - 1;
    const Ray qm = shfl_ray(q, m);
    const float cap = __shfl_sync(kFull, best, m);
    int j_min;
    const float t_min = warp_closest(wc, qm, cap, lane, j_min);
    if (lane == m && t_min < best) {
      best = t_min;
      best_slot = c * kClusterSize + j_min;
      improved = true;
    }
  }
  return improved;
}

// Any hit: for each lane of `group`, whether some triangle of the cluster
// lies strictly inside (T_MIN, cap) of that lane's ray and cap. Returns
// true on a lane whose ray is occluded.
__device__ __forceinline__ bool warp_any_group(const WarpCluster& wc,
                                               unsigned group, const Ray& q,
                                               float cap, int lane) {
  bool occluded = false;
  while (group != 0) {
    const int m = __ffs(group) - 1;
    group &= group - 1;
    const Ray qm = shfl_ray(q, m);
    const float cap_m = __shfl_sync(kFull, cap, m);
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kTriPerLane; ++k) {
      hit = hit || woop_test(wc.tri[k], qm, cap_m) < cap_m;
    }
    if (__any_sync(kFull, hit) && lane == m) occluded = true;
  }
  return occluded;
}

// Write ray i's closest-hit result, its normal and material read from the
// cluster tables (normal 0 and mat 0 on a miss).
__device__ __forceinline__ void store_closest(
    int i, float best, int best_slot, const float* __restrict__ normal,
    const int* __restrict__ mat, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ normal_out,
    int* __restrict__ mat_out) {
  t_out[i] = best;
  slot_out[i] = best_slot;
  if (best_slot >= 0) {
    const int c = best_slot / kClusterSize;
    const int lane = best_slot % kClusterSize;
    const float* nc = normal + static_cast<size_t>(c) * 3 * kClusterSize;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      normal_out[3 * i + a] = nc[a * kClusterSize + lane];
    }
    mat_out[i] = mat[static_cast<size_t>(c) * kClusterSize + lane];
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) normal_out[3 * i + a] = 0.0f;
    mat_out[i] = 0;
  }
}

// Write ray i's closest-hit result of the tree walks: the normal is the
// winner's Woop w-row normalised with rsqrt, as the JAX tree kernels
// compute it, and the material comes from the table (normal 0 and mat 0 on
// a miss).
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

}  // namespace ptpu
