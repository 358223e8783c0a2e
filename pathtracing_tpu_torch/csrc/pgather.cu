// Row gather for Hopper (sm_90a): out[n, :] = table[clamp(idx[n], 0, L-1), :]
// for an (L, W) float32 table and N integer indices, an exact copy.
//
// Replaces the TPU kernel of the JAX package:
//   gather_rows_kernel <- pathtracing_tpu/ops/pgather.py gather_rows (_kernel)
// whose transposed, lane-padded table, 128-column chunk loop and 8 MB VMEM
// ceiling exist only because the TPU gathers along lanes of a resident
// tile; none of that is carried over. Any L >= 1, W >= 1 and N are taken.
//
// What bounds it on this card: bytes. Each index is read once, each output
// row written once, and the table (27 KB for the many-light scene's
// (288, 24) rows) is read from L1/L2 after its first touch; there is no
// arithmetic beyond the clamp.
//
// Design: one thread per 16-byte piece of an output row when W is a
// multiple of 4 and both pointers are 16-byte aligned (W/4 threads per row,
// consecutive threads on consecutive float4s, so the writes of a warp are
// one contiguous span), else one thread per float. The threads of a row
// read the same index (a broadcast load). A grid-stride loop covers any N.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxGrid = 1 << 20;

template <typename Index>
__device__ __forceinline__ long long clamped(const Index* __restrict__ idx,
                                             long long n, int n_rows) {
  long long v = static_cast<long long>(idx[n]);
  v = v < 0 ? 0 : v;
  return v > n_rows - 1 ? n_rows - 1 : v;
}

// Vec = float4 (per_row = W / 4) or float (per_row = W).
template <typename Index, typename Vec>
__global__ void __launch_bounds__(kBlock)
gather_rows_kernel(const Vec* __restrict__ table,
                   const Index* __restrict__ idx, int n_rows, int per_row,
                   long long total, Vec* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < total; g += stride) {
    const long long n = g / per_row;
    const int col = static_cast<int>(g - n * per_row);
    out[g] = table[clamped(idx, n, n_rows) * per_row + col];
  }
}

template <typename Index>
int launch(const float* table, const Index* idx, int n_rows, int width,
           long long n, float* out, cudaStream_t s) {
  const bool vec =
      width % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) %
              16 == 0;
  const int per_row = vec ? width / 4 : width;
  const long long total = n * per_row;
  const long long blocks = (total + kBlock - 1) / kBlock;
  const int grid = static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
  if (vec) {
    gather_rows_kernel<Index, float4><<<grid, kBlock, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx, n_rows, per_row, total,
        reinterpret_cast<float4*>(out));
  } else {
    gather_rows_kernel<Index, float><<<grid, kBlock, 0, s>>>(
        table, idx, n_rows, per_row, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx_is_64: the indices are int64 (else int32).
int ptpu_gather_rows(const float* table, const void* idx, int idx_is_64,
                     int n_rows, int width, long long n, float* out,
                     void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_is_64) {
    return launch(table, static_cast<const long long*>(idx), n_rows, width, n,
                  out, s);
  }
  return launch(table, static_cast<const int*>(idx), n_rows, width, n, out,
                s);
}

}  // extern "C"
