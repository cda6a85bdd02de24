// Shared helpers for the port's CUDA kernels (plain C interface, no PyTorch
// headers).  Element types: float and __nv_bfloat16; all arithmetic in float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace emo {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Rounds a float through the element type (identity for float): the JAX
// kernels cast softmax probabilities and context rows to the compute dtype
// before the next product, and so do these.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Exact-erf GELU (torch nn.GELU(), HF WavLM).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stateless keep mask of the train-time dropouts, bit for bit the JAX
// package's `_hash_keep`: two murmur3 finalizer rounds over (element index ^
// stream base), all in arithmetic that wraps mod 2^32; an element is kept iff
// the hash is >= threshold = min(round(rate * 2^32), 2^32 - 1).
__device__ __forceinline__ bool hash_keep(unsigned base, unsigned index, unsigned threshold) {
  unsigned x = index ^ base;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

// Stream bases: one per batch element, then one per head for the attention
// probabilities (index space Tp x Tp) and one for the projected output
// (index space Tp x E).
__device__ __forceinline__ unsigned dropout_stream(unsigned seed, int b) {
  return seed + static_cast<unsigned>(b) * 0x632BE59Bu;
}
__device__ __forceinline__ unsigned attn_stream(unsigned seed, int b, int h) {
  return dropout_stream(seed, b) + static_cast<unsigned>(h + 1) * 0x9E3779B9u;
}
__device__ __forceinline__ unsigned hidden_stream(unsigned seed, int b) {
  return dropout_stream(seed, b) + 0x7FEB352Du;
}

// K1's dropout seed: the int32 at `seed_dev` where the caller keeps it in
// device memory (a captured CUDA graph replays each step's seed from
// there), else the `seed` argument.  Each kernel reads it first thing.
__device__ __forceinline__ unsigned k1_seed(unsigned seed, const int* seed_dev) {
  return seed_dev != nullptr ? static_cast<unsigned>(__ldg(seed_dev)) : seed;
}

}  // namespace emo
