// Shared device helpers of the cluster-sweep traversal kernels
// (cluster_trace.cu: flat scenes; cluster_trace_inst.cu: instanced scenes):
// the ray record, the safe reciprocal, the shared-memory box staging, the
// slab test and the Woop triangle test. Every multiply and add is written
// in the order of the plain torch versions (ops/cluster_trace.py: _slab,
// _pair_eval) and the sources are built with --fmad=false, so a kernel's t
// equals its plain version's bit for bit.

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

__device__ __forceinline__ bool slab(const float (*box)[kBoxChunk], int k,
                                     const Ray& r, float best) {
  float tn = -kBig;
  float tf = kBig;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (box[a][k] - r.o[a]) * r.inv[a];
    const float t1 = (box[3 + a][k] - r.o[a]) * r.inv[a];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  return (tn <= tf) && (tf > kTMin) && (tn < best);
}

// Woop evaluation of triangle `j` of one cluster (w points at its
// (4, 384) tensor). Returns t, or kBig when the ray misses it or the hit
// is not inside (T_MIN, cap). Operation order matches _pair_eval.
__device__ __forceinline__ float woop_hit(const float* __restrict__ w,
                                          int j, const Ray& r, float cap) {
  float op[3];
  float dp[3];
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    const int col = comp * kClusterSize + j;
    const float w0 = __ldg(w + col);
    const float w1 = __ldg(w + kWoopCols + col);
    const float w2 = __ldg(w + 2 * kWoopCols + col);
    const float w3 = __ldg(w + 3 * kWoopCols + col);
    float o = w3 + r.o[0] * w0;
    o = o + r.o[1] * w1;
    o = o + r.o[2] * w2;
    float d = r.d[0] * w0;
    d = d + r.d[1] * w1;
    d = d + r.d[2] * w2;
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

}  // namespace ptpu
