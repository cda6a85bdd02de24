// Device functions shared by the cross-attention fusion kernels: K4, the
// whole fusion block (`fused_block.cu`), and K5, its attention core
// (`xattn.cu`).  Both work on one sample's tokens, T video rows and Ta audio
// rows of width d, all in float32:
//
//   v' = LN(v + MHA(q = v, kv = a) )          additive bias [T, Ta] optional
//   a' = LN(a + MHA(q = a, kv = v'))          a2v sees the UPDATED video tokens
//
// How the work is cut.  Every product whose rows are audio tokens and whose
// operand does not depend on v' is row-independent, so a first kernel
// (`project_audio_rows`, a grid over row tiles and samples) writes the audio
// tokens' K and V for v2a and their Q for a2v to a float32 scratch in device
// memory, where they stay in L2.  A second kernel, one block for one or more
// samples, then holds everything else of a sample in shared memory
// (`bidirectional_attention`): the 8-row video side, the score tiles, the a2v
// context [Ta, d] and the updated audio tokens [Ta, d].
//
// `linear` is the one matrix product: X [rows, K] in shared memory times a
// weight [K, N] read as it lies in device memory (float32, or int8 with one
// float32 scale per output column, dequantised on the fly), each thread
// owning one output column for a chunk of 8 rows, so weight reads are
// coalesced and X reads are broadcasts.  CUDA-core FMAs in float32, sums in
// order over k: simple and right first; tensor cores are later work.  The
// loops that read device memory are unrolled so that several loads are in
// flight: each block is one chain of dependent steps, bound by load latency.
//
// The pointer table that the C entry points take (`Tensor`, `Matrix`,
// `Vector`, `Int` below) is mirrored, in the same order, by
// `kernels/xattn.py`.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace emo {
namespace fusion {

constexpr int kCoreThreads = 512;   // block of a per-sample kernel
constexpr int kTileThreads = 256;   // block of a row-tile kernel
constexpr int kTileRows = 16;       // audio rows per block of a row-tile kernel
constexpr int kRowsPerThread = 8;   // rows per thread in `linear`
constexpr int kMaxT = 16;           // video tokens per sample (kept in registers)
constexpr int kMaxSmem = 227 * 1024;

enum Tensor : int {
  kVIn = 0,    // K4: v_feat [B, T, Dv] (compute dtype); K5: v tokens [B, T, d] f32
  kAIn,        // K4: a_seq [B, Ta, Ds] (compute dtype); K5: unused
  kBiasV2a,    // K5: [B, T, Ta] f32 or null
  kBiasA2v,    // K5: [B, Ta, T] f32 or null
  kATok,       // audio tokens [B, Ta, d] f32 (K4: scratch, written; K5: input)
  kKa,         // scratch [B, Ta, d] f32: v2a keys
  kVa,         // scratch [B, Ta, d] f32: v2a values
  kQa,         // scratch [B, Ta, d] f32: a2v queries, pre-scaled by dh^-0.5
  kOut,        // K4: logits [B, C] f32
  kOutV,       // K5: v_emb [B, d] f32
  kOutA,       // K5: a_emb [B, d] f32
  kWork,       // K4's tensor-core route: float32 workspace (`fused_block_tc.cuh::Work`)
  kNumTensors
};

// Weights [in, out], row-major; two table entries each (data, scale or null).
enum Matrix : int {
  kVinW = 0, kAseqW, kAinW, kV2aInW, kV2aOutW, kA2vInW, kA2vOutW,
  kEpP0W, kEpP3W, kEpVqW, kEpAkW, kEpAqW, kEpVkW,
  kVpW1, kVpW2, kApW1, kApW2,
  kHW1, kHW2, kGW1, kGW2, kCW,
  kEpTokW,  // K4's tensor-core route: [d, 4] token parts of the ak, aq, vq, vk score weights
  kNumMatrices
};

// float32 vectors (biases, LayerNorm scales, the prior's bias scale).
enum Vector : int {
  kVinB = 0, kAseqB, kAinB, kV2aInB, kV2aOutB, kA2vInB, kA2vOutB,
  kVnS, kVnB, kAnS, kAnB,
  kEpP0B, kEpP3B, kEpVqB, kEpAkB, kEpAqB, kEpVkB, kEpScale,
  kVpLnS, kVpLnB, kVpB1, kVpB2, kApLnS, kApLnB, kApB1, kApB2,
  kHB1, kHB2, kGB1, kGB2, kCB,
  kNumVectors
};

enum Int : int {
  kB = 0, kT, kTa, kDv, kDs, kD, kH, kC, kPoolHidden, kPriorDim, kPriorHidden,
  kHeadHidden, kPooling, kHead, kBiasMode, kSamplesPerBlock, kWorkFloats,
  kNumInts
};

constexpr int kNumPointers = kNumTensors + 2 * kNumMatrices + kNumVectors;

enum { kPoolMean = 0, kPoolAttn = 1 };
enum { kHeadConcat = 0, kHeadGated = 1 };
enum { kBiasNone = 0, kBiasPrior = 1, kBiasExternal = 2 };
enum { kActNone = 0, kActRelu = 1, kActGelu = 2 };

struct Mat {
  const void* w;       // float32 or int8 [K, N]
  const float* scale;  // [N] when int8, else null
};

struct Params {
  void* t[kNumTensors];
  Mat m[kNumMatrices];
  const float* v[kNumVectors];
  int B, T, Ta, Dv, Ds, d, H, C, pool_hidden, prior_dim, prior_hidden, head_hidden;
  int pooling, head, bias_mode, samples_per_block, work_floats;
  float eps, qscale;
};

// Fills `p` from the entry point's tables; false when the counts or the
// shapes are outside what the kernels take.
inline bool unpack(const void* const* ptrs, int n_ptrs, const int* ints, int n_ints,
                   float eps, float qscale, Params* p) {
  if (n_ptrs != kNumPointers || n_ints != kNumInts) return false;
  int at = 0;
  for (int i = 0; i < kNumTensors; ++i) p->t[i] = const_cast<void*>(ptrs[at++]);
  for (int i = 0; i < kNumMatrices; ++i) {
    p->m[i].w = ptrs[at++];
    p->m[i].scale = static_cast<const float*>(ptrs[at++]);
  }
  for (int i = 0; i < kNumVectors; ++i) p->v[i] = static_cast<const float*>(ptrs[at++]);
  p->B = ints[kB]; p->T = ints[kT]; p->Ta = ints[kTa]; p->Dv = ints[kDv];
  p->Ds = ints[kDs]; p->d = ints[kD]; p->H = ints[kH]; p->C = ints[kC];
  p->pool_hidden = ints[kPoolHidden]; p->prior_dim = ints[kPriorDim];
  p->prior_hidden = ints[kPriorHidden]; p->head_hidden = ints[kHeadHidden];
  p->pooling = ints[kPooling]; p->head = ints[kHead]; p->bias_mode = ints[kBiasMode];
  p->samples_per_block = ints[kSamplesPerBlock];
  p->work_floats = ints[kWorkFloats];
  p->eps = eps;
  p->qscale = qscale;  // dh^-0.5, rounded once by the caller
  return p->B >= 1 && p->T >= 1 && p->T <= kMaxT && p->Ta >= 1 && p->d >= 1 &&
         p->H >= 1 && p->d % p->H == 0 && p->H * p->T <= p->d &&
         p->samples_per_block >= 1;
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == kActRelu) return fmaxf(y, 0.f);
  if (act == kActGelu) return gelu_erf(y);
  return y;
}

// Y[r * ldy + n] = act(bias[n] + sum_k X[r * ldx + k] * W[k * ldw + col0 + n]) * out_scale
// for r < rows, n < N.  X is in shared memory; Y in shared or device memory;
// `bias` (may be null) already points at column col0.  Every thread of the
// block calls it; the caller synchronises before and after.
template <bool kInt8>
__device__ void linear_impl(const float* X, int ldx, int rows, int K, const Mat W,
                            int ldw, int col0, const float* bias, int N, float* Y,
                            int ldy, int act, float out_scale) {
  const int chunks = (rows + kRowsPerThread - 1) / kRowsPerThread;
  const bool vec = (K % 4 == 0) && (ldx % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(X) % 16 == 0);
  for (int item = threadIdx.x; item < N * chunks; item += blockDim.x) {
    const int n = item % N;
    const int r0 = (item / N) * kRowsPerThread;
    const float* wf = static_cast<const float*>(W.w) + col0 + n;
    const int8_t* wq = static_cast<const int8_t*>(W.w) + col0 + n;
    const float sc = kInt8 ? W.scale[col0 + n] : 1.f;
    const float* xr[kRowsPerThread];
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      xr[i] = X + (size_t)min(r0 + i, rows - 1) * ldx;  // rows past the end repeat the last
      acc[i] = 0.f;
    }
    if (vec) {
#pragma unroll 2
      for (int k = 0; k < K; k += 4) {
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const size_t at = (size_t)(k + u) * ldw;
          w[u] = kInt8 ? static_cast<float>(wq[at]) * sc : wf[at];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(xr[i] + k);
          acc[i] = fmaf(x.x, w[0], acc[i]);
          acc[i] = fmaf(x.y, w[1], acc[i]);
          acc[i] = fmaf(x.z, w[2], acc[i]);
          acc[i] = fmaf(x.w, w[3], acc[i]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const size_t at = (size_t)k * ldw;
        const float w = kInt8 ? static_cast<float>(wq[at]) * sc : wf[at];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i] = fmaf(xr[i][k], w, acc[i]);
      }
    }
    const float b = bias ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      if (r0 + i < rows)
        Y[(size_t)(r0 + i) * ldy + n] = activate(acc[i] + b, act) * out_scale;
  }
}

__device__ __forceinline__ void linear(const float* X, int ldx, int rows, int K,
                                       const Mat W, int ldw, int col0,
                                       const float* bias, int N, float* Y, int ldy,
                                       int act = kActNone, float out_scale = 1.f) {
  if (W.scale)
    linear_impl<true>(X, ldx, rows, K, W, ldw, col0, bias, N, Y, ldy, act, out_scale);
  else
    linear_impl<false>(X, ldx, rows, K, W, ldw, col0, bias, N, Y, ldy, act, out_scale);
}

__device__ __forceinline__ float mat_at(const Mat W, int idx, int col) {
  return W.scale ? static_cast<float>(static_cast<const int8_t*>(W.w)[idx]) * W.scale[col]
                 : static_cast<const float*>(W.w)[idx];
}

// out[r] = add + sum_k X[r * ldx + k] * w[k]  for a one-column weight (its
// first K rows); one warp per row.  X in shared or device memory.
__device__ inline void row_dots(const float* X, int ldx, int rows, int K, const Mat w,
                         float add, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s = fmaf(X[(size_t)r * ldx + k], mat_at(w, k, 0), s);
    s = warp_sum(s);
    if (lane == 0) out[r] = s + add;
  }
}

// Y[r] = LayerNorm(X[r] + R[r]) * scale + bias over d columns, one warp per
// row; R may be null, X == Y is allowed.  Statistics as the reference takes
// them: mean, then the mean of squared deviations.
__device__ inline void layer_norm_rows(const float* X, int ldx, const float* R, int ldr,
                                int rows, int d, const float* scale, const float* bias,
                                float eps, float* Y, int ldy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    const float* x = X + (size_t)r * ldx;
    const float* res = R ? R + (size_t)r * ldr : nullptr;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += x[c] + (res ? res[c] : 0.f);
    const float mean = warp_sum(s) / d;
    float q = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dev = x[c] + (res ? res[c] : 0.f) - mean;
      q = fmaf(dev, dev, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float val = x[c] + (res ? res[c] : 0.f);
      Y[(size_t)r * ldy + c] = (val - mean) * rstd * scale[c] + bias[c];
    }
  }
}

// In-place softmax of p[0..n) by one warp.
__device__ __forceinline__ void softmax_row(float* p, int n) {
  const int lane = threadIdx.x & 31;
  float m = -3.402823466e38f;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, p[j]);
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(p[j] - m);
    p[j] = e;
    l += e;
  }
  l = warp_sum(l);
  for (int j = lane; j < n; j += 32) p[j] = p[j] / l;
}

// out[c] = mean over rows of X[r * ld + c], c < d.
__device__ __forceinline__ void mean_rows(const float* X, int ld, int rows, int d,
                                          float* out) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) s += X[(size_t)r * ld + c];
    out[c] = s / rows;
  }
}

// The additive attention bias of one sample: none, the emotion prior's
// tanh(query score + key score) * scale from per-token scores in shared
// memory, or arrays given by the caller.
struct AttnBias {
  int mode;
  const float *vq, *ak, *aq, *vk;  // prior: token scores [T], [Ta], [Ta], [T]
  float scale;
  const float *v2a, *a2v;  // external: [T, Ta] and [Ta, T] of this sample
};

__device__ __forceinline__ float bias_v2a(const AttnBias& b, int i, int j, int Ta) {
  if (b.mode == kBiasPrior) return tanhf(b.vq[i] + b.ak[j]) * b.scale;
  if (b.mode == kBiasExternal) return b.v2a[(size_t)i * Ta + j];
  return 0.f;
}

__device__ __forceinline__ float bias_a2v(const AttnBias& b, int j, int i, int T) {
  if (b.mode == kBiasPrior) return tanhf(b.aq[j] + b.vk[i]) * b.scale;
  if (b.mode == kBiasExternal) return b.a2v[(size_t)j * T + i];
  return 0.f;
}

// For `rows` audio tokens `at` [rows, d] in shared memory: the v2a keys and
// values and the pre-scaled a2v queries, written to device memory at ka, va,
// qa (pointers at the tile's first row, row stride d).
__device__ inline void project_audio_rows(const Params& p, const float* at, int rows,
                                   float* ka, float* va, float* qa) {
  const int d = p.d;
  linear(at, d, rows, d, p.m[kV2aInW], 3 * d, d, p.v[kV2aInB] + d, d, ka, d);
  linear(at, d, rows, d, p.m[kV2aInW], 3 * d, 2 * d, p.v[kV2aInB] + 2 * d, d, va, d);
  linear(at, d, rows, d, p.m[kA2vInW], 3 * d, 0, p.v[kA2vInB], d, qa, d, kActNone,
         p.qscale);
}

// Shared-memory buffers of one sample in a per-sample kernel.
struct Arena {
  float* big0;  // [Ta, d]  a2v context; scratch before
  float* big1;  // [Ta, d]  score tiles, then the updated audio tokens a'
  float* vtok;  // [T, d]   video tokens v, then v'
  float* vt1;   // [T, d]
  float* vt2;   // [T, d]
  float* vkv;   // [T, d]   a2v keys (from v')
  float* vvv;   // [T, d]   a2v values (from v')
};

// Both attention directions with their residual LayerNorms for sample s.
// In: video tokens in ar.vtok, audio tokens and their projections in device
// memory (kATok, kKa, kVa, kQa).  Out: v' in ar.vtok, a' in ar.big1.  Every
// thread of the block calls it; it ends synchronised.
__device__ inline void bidirectional_attention(const Params& p, const Arena& ar,
                                        const AttnBias& bias, int s) {
  const int T = p.T, Ta = p.Ta, d = p.d, H = p.H, dh = d / H;
  const size_t off = (size_t)s * Ta * d;
  const float* a_g = static_cast<const float*>(p.t[kATok]) + off;
  const float* ka_g = static_cast<const float*>(p.t[kKa]) + off;
  const float* va_g = static_cast<const float*>(p.t[kVa]) + off;
  const float* qa_g = static_cast<const float*>(p.t[kQa]) + off;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float* P = ar.big1;  // v2a: [(h*T + i) * Ta + j]; a2v: the same index

  // --- v2a: queries from v, keys and values from the audio tokens.
  linear(ar.vtok, d, T, d, p.m[kV2aInW], 3 * d, 0, p.v[kV2aInB], d, ar.vt1, d,
         kActNone, p.qscale);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * Ta; idx += blockDim.x) {
    const int h = idx / Ta, j = idx - h * Ta;
    float acc[kMaxT];
#pragma unroll
    for (int i = 0; i < kMaxT; ++i) acc[i] = 0.f;
    const float* kr = ka_g + (size_t)j * d + h * dh;
#pragma unroll 8
    for (int c = 0; c < dh; ++c) {
      const float kv = kr[c];
#pragma unroll
      for (int i = 0; i < kMaxT; ++i)
        if (i < T) acc[i] = fmaf(ar.vt1[i * d + h * dh + c], kv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kMaxT; ++i)
      if (i < T) P[(size_t)(h * T + i) * Ta + j] = acc[i] + bias_v2a(bias, i, j, Ta);
  }
  __syncthreads();
  for (int row = warp; row < H * T; row += warps) softmax_row(P + (size_t)row * Ta, Ta);
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) {
    const int i = idx / d, c = idx - i * d, h = c / dh;
    const float* pr = P + (size_t)(h * T + i) * Ta;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < Ta; ++j) acc = fmaf(pr[j], va_g[(size_t)j * d + c], acc);
    ar.vt2[idx] = acc;
  }
  __syncthreads();
  linear(ar.vt2, d, T, d, p.m[kV2aOutW], d, 0, p.v[kV2aOutB], d, ar.vt1, d);
  __syncthreads();
  layer_norm_rows(ar.vtok, d, ar.vt1, d, T, d, p.v[kVnS], p.v[kVnB], p.eps, ar.vtok, d);
  __syncthreads();

  // --- a2v: queries from the audio tokens, keys and values from v'.
  linear(ar.vtok, d, T, d, p.m[kA2vInW], 3 * d, d, p.v[kA2vInB] + d, d, ar.vkv, d);
  linear(ar.vtok, d, T, d, p.m[kA2vInW], 3 * d, 2 * d, p.v[kA2vInB] + 2 * d, d, ar.vvv, d);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * Ta; idx += blockDim.x) {
    const int h = idx / Ta, j = idx - h * Ta;
    float acc[kMaxT];
#pragma unroll
    for (int i = 0; i < kMaxT; ++i) acc[i] = 0.f;
    const float* qr = qa_g + (size_t)j * d + h * dh;
#pragma unroll 8
    for (int c = 0; c < dh; ++c) {
      const float q = qr[c];
#pragma unroll
      for (int i = 0; i < kMaxT; ++i)
        if (i < T) acc[i] = fmaf(q, ar.vkv[i * d + h * dh + c], acc[i]);
    }
    float m = -3.402823466e38f;
#pragma unroll
    for (int i = 0; i < kMaxT; ++i)
      if (i < T) {
        acc[i] += bias_a2v(bias, j, i, T);
        m = fmaxf(m, acc[i]);
      }
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxT; ++i)
      if (i < T) {
        acc[i] = expf(acc[i] - m);
        l += acc[i];
      }
#pragma unroll
    for (int i = 0; i < kMaxT; ++i)
      if (i < T) P[(size_t)(h * T + i) * Ta + j] = acc[i] / l;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Ta * d; idx += blockDim.x) {
    const int j = idx / d, c = idx - j * d, h = c / dh;
    float acc = 0.f;
    for (int i = 0; i < T; ++i)
      acc = fmaf(P[(size_t)(h * T + i) * Ta + j], ar.vvv[i * d + c], acc);
    ar.big0[idx] = acc;
  }
  __syncthreads();
  linear(ar.big0, d, Ta, d, p.m[kA2vOutW], d, 0, p.v[kA2vOutB], d, ar.big1, d);
  __syncthreads();
  layer_norm_rows(ar.big1, d, a_g, d, Ta, d, p.v[kAnS], p.v[kAnB], p.eps, ar.big1, d);
  __syncthreads();
}

// Floats of shared memory the Arena takes.
inline size_t arena_floats(const Params& p) {
  return 2 * (size_t)p.Ta * p.d + 5 * (size_t)p.T * p.d;
}

__device__ __forceinline__ float* carve_arena(float* smem, const Params& p, Arena* ar) {
  const size_t big = (size_t)p.Ta * p.d, small = (size_t)p.T * p.d;
  ar->big0 = smem;
  ar->big1 = ar->big0 + big;
  ar->vtok = ar->big1 + big;
  ar->vt1 = ar->vtok + small;
  ar->vt2 = ar->vt1 + small;
  ar->vkv = ar->vt2 + small;
  ar->vvv = ar->vkv + small;
  return ar->vvv + small;
}

}  // namespace fusion
}  // namespace emo
