// Counter-based generator for Hopper (sm_90a): Threefry-2x32 keys,
// fold_in chains, random bits and uniforms, and the low-discrepancy
// draws, bit for bit as the plain int64 version of ops/rng.py computes
// them (and so as jax.random computes them with
// jax_threefry_partitionable=True).
//
// Replaces no TPU kernel: the JAX package's ops/rng.py is jax.random,
// which XLA fuses into the surrounding shading. In plain torch every
// 32-bit step is an int64 op over the whole wave (about 170 of them for
// one threefry), so a 1080p frame issued about 10,000 of them.
//
// What bounds it on this card: nothing much. Each lane reads a key (16 B)
// or a pixel id and a sample id and writes 4-16 B (100 B for 25 uniforms);
// a threefry is about 80 32-bit integer instructions in registers. A
// 1080p wave takes tens of microseconds; the host's launch is most of the
// cost.
//
// Design: one thread a lane (an output element for the bits), a
// grid-stride loop, the whole chain in registers. Integer operands come
// as launch arguments (`Word`): a value given at launch, or int32/int64
// words read per lane (stride 1) or once (stride 0, a broadcast), each
// taken modulo 2^32 as the plain version's `& 0xFFFFFFFF` takes it. Keys
// are int64 (lanes, 2) tables holding two 32-bit words, or words given at
// launch (`key(seed)`).
//
//   fold_kernel      key -> fold_in(d0) -> fold_in(d1) -> fold_in(d2)
//                    (0-3 folds): key, fold_in, stream_key and
//                    pixel_sample_key
//   bits_kernel<U>   jax.random.bits / uniform of n counters per key
//   ld_kernel<D>     key(seed) -> fold_in(pixel) -> fold_in(tag)
//                    [-> fold_in(salt)] -> uniform rotation(s) -> radical
//                    inverse of the sample index in the stream's prime
//                    base(s) -> fractional part (ld_scalar: D = 1,
//                    ld_pair: D = 2)
//
// Float rounding: the radical inverse adds `float(n % base) * scale` in
// the plain version's order, each step rounded (`__fmul_rn`, `__fadd_rn`;
// the build's --fmad=false keeps the rest uncontracted), with the scale
// sequence scale_0 = float(1 / base), scale_k+1 = scale_k * scale_0 in
// float. The plain loop runs a fixed digit count; digits past the last
// nonzero one add +0.0, so stopping at n == 0 gives the same float.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxGrid = 1 << 20;

struct Word {
  const void* ptr;   // null: `value` for every lane
  int is64;          // int64 words, else int32
  int stride;        // 1: one word a lane; 0: one word for all
  uint32_t value;
};

struct KeySrc {
  const long long* ptr;   // null: (k0, k1) for every lane
  int stride;             // 1: one pair a lane; 0: one pair for all
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t word_at(const Word& w, long long lane) {
  if (w.ptr == nullptr) return w.value;
  const long long i = lane * w.stride;
  return w.is64
             ? static_cast<uint32_t>(static_cast<const long long*>(w.ptr)[i])
             : static_cast<uint32_t>(static_cast<const int*>(w.ptr)[i]);
}

__device__ __forceinline__ void key_at(const KeySrc& k, long long lane,
                                       uint32_t& k0, uint32_t& k1) {
  if (k.ptr == nullptr) {
    k0 = k.k0;
    k1 = k.k1;
    return;
  }
  const long long i = 2 * lane * k.stride;
  k0 = static_cast<uint32_t>(k.ptr[i]);
  k1 = static_cast<uint32_t>(k.ptr[i + 1]);
}

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = ((x1 << R) | (x1 >> (32 - R))) ^ x0;
}

// Threefry-2x32, 20 rounds: five groups of four, rotations (13, 15, 26, 6)
// and (17, 29, 16, 24) in turn, a key injection after each group.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

// jax.random.fold_in: the key becomes threefry2x32(key, (0, d)).
__device__ __forceinline__ void fold(uint32_t& k0, uint32_t& k1, uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// The 32-bit word of counter i under a key (jax.random.bits).
__device__ __forceinline__ uint32_t bits_of(uint32_t k0, uint32_t k1,
                                            uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// A uniform float32 in [0, 1): the word's top 23 bits as a mantissa of
// [1, 2), less one.
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// The base-`base` radical inverse of n in float32 (base 2: the reversed
// bits scaled by 2^-32).
__device__ __forceinline__ float radical_inverse(uint32_t n, int base) {
  if (base == 2) {
    return __fmul_rn(__uint2float_rn(__brev(n)),
                     __uint_as_float(0x2F800000u));   // 2^-32
  }
  const uint32_t b = static_cast<uint32_t>(base);
  const float inv = __double2float_rn(1.0 / static_cast<double>(base));
  float scale = inv;
  float r = 0.0f;
  while (n != 0u) {
    r = __fadd_rn(r, __fmul_rn(__uint2float_rn(n % b), scale));
    n /= b;
    scale = __fmul_rn(scale, inv);
  }
  return r;
}

__device__ __forceinline__ float rotated(uint32_t s, int base, float rot) {
  const float u = __fadd_rn(radical_inverse(s, base), rot);
  return __fsub_rn(u, floorf(u));
}

__global__ void __launch_bounds__(kBlock)
fold_kernel(KeySrc key, Word d0, Word d1, Word d2, int n_folds,
            long long lanes, long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
       lane < lanes; lane += stride) {
    uint32_t k0, k1;
    key_at(key, lane, k0, k1);
    if (n_folds > 0) fold(k0, k1, word_at(d0, lane));
    if (n_folds > 1) fold(k0, k1, word_at(d1, lane));
    if (n_folds > 2) fold(k0, k1, word_at(d2, lane));
    out[2 * lane] = static_cast<long long>(k0);
    out[2 * lane + 1] = static_cast<long long>(k1);
  }
}

// n counters a key; output element g = (lane, i) with lane = g / n.
template <bool kUniform>
__global__ void __launch_bounds__(kBlock)
bits_kernel(KeySrc key, int n, long long total, void* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < total; g += stride) {
    const long long lane = n == 1 ? g : g / n;
    const uint32_t i = static_cast<uint32_t>(g - lane * n);
    uint32_t k0, k1;
    key_at(key, lane, k0, k1);
    const uint32_t b = bits_of(k0, k1, i);
    if (kUniform) {
      static_cast<float*>(out)[g] = uniform_of(b);
    } else {
      static_cast<long long*>(out)[g] = static_cast<long long>(b);
    }
  }
}

template <int kDims>
__global__ void __launch_bounds__(kBlock)
ld_kernel(uint32_t seed0, uint32_t seed1, Word pixel, uint32_t tag,
          int salted, uint32_t salt, Word sample, int base0, int base1,
          long long lanes, float* __restrict__ out0,
          float* __restrict__ out1) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
       lane < lanes; lane += stride) {
    uint32_t k0 = seed0, k1 = seed1;
    fold(k0, k1, word_at(pixel, lane));
    fold(k0, k1, tag);
    if (salted) fold(k0, k1, salt);
    const uint32_t s = word_at(sample, lane);
    out0[lane] = rotated(s, base0, uniform_of(bits_of(k0, k1, 0u)));
    if (kDims == 2) {
      out1[lane] = rotated(s, base1, uniform_of(bits_of(k0, k1, 1u)));
    }
  }
}

int grid_for(long long total) {
  const long long blocks = (total + kBlock - 1) / kBlock;
  return static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

Word word_of(const void* ptr, int is64, int stride, unsigned value) {
  return Word{ptr, is64, stride, static_cast<uint32_t>(value)};
}

}  // namespace

extern "C" {

// key: (lanes or 1, 2) int64, or null for (key0, key1); each fold operand
// (d*, d*_is64, d*_stride, d*_value) as `Word`; out: (lanes, 2) int64.
int ptpu_rng_fold(const long long* key, int key_stride, unsigned key0,
                  unsigned key1, int n_folds, const void* d0, int d0_is64,
                  int d0_stride, unsigned d0_value, const void* d1,
                  int d1_is64, int d1_stride, unsigned d1_value,
                  const void* d2, int d2_is64, int d2_stride,
                  unsigned d2_value, long long lanes, long long* out,
                  void* stream) {
  if (lanes <= 0) return 0;
  fold_kernel<<<grid_for(lanes), kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      KeySrc{key, key_stride, key0, key1},
      word_of(d0, d0_is64, d0_stride, d0_value),
      word_of(d1, d1_is64, d1_stride, d1_value),
      word_of(d2, d2_is64, d2_stride, d2_value), n_folds, lanes, out);
  return static_cast<int>(cudaGetLastError());
}

// key: (lanes or 1, 2) int64; out: lanes * n int64 words (as_uniform 0)
// or float32 uniforms (as_uniform 1).
int ptpu_rng_bits(const long long* key, int key_stride, long long lanes,
                  int n, int as_uniform, void* out, void* stream) {
  const long long total = lanes * n;
  if (total <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KeySrc k{key, key_stride, 0u, 0u};
  if (as_uniform) {
    bits_kernel<true><<<grid_for(total), kBlock, 0, s>>>(k, n, total, out);
  } else {
    bits_kernel<false><<<grid_for(total), kBlock, 0, s>>>(k, n, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// base1 0: ld_scalar (out0 only), else ld_pair (out0, out1).
int ptpu_rng_ld(unsigned seed0, unsigned seed1, const void* pix,
                int pix_is64, int pix_stride, unsigned pix_value,
                unsigned tag, int salted, unsigned salt, const void* sample,
                int sample_is64, int sample_stride, unsigned sample_value,
                int base0, int base1, long long lanes, float* out0,
                float* out1, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Word p = word_of(pix, pix_is64, pix_stride, pix_value);
  const Word q = word_of(sample, sample_is64, sample_stride, sample_value);
  if (base1 == 0) {
    ld_kernel<1><<<grid_for(lanes), kBlock, 0, s>>>(
        seed0, seed1, p, tag, salted, salt, q, base0, 0, lanes, out0, out1);
  } else {
    ld_kernel<2><<<grid_for(lanes), kBlock, 0, s>>>(
        seed0, seed1, p, tag, salted, salt, q, base0, base1, lanes, out0,
        out1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
