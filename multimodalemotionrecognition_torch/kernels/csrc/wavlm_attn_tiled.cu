// K6: the WavLM attention sublayer (eval), G batch elements per thread block.
//
// Replaces the TPU kernel `benchmarks/bench_attn_tile.py::_tiled_kernel`
// (launched by `tiled_call`): K1's eval arithmetic with a grid over B / G
// instead of B, every G giving the same result bit for bit.  Per batch element,
// head h and query row i < Tp (q pre-scaled):
//
//   s[j]   = q_h[i] . k_h[j] + gate[b, h*Tp + i] * bias[h*Tp + i, j]   j < seq_len
//   p      = softmax(s)        (float32; key columns >= seq_len carry weight 0)
//   ctx_h  = sum_j p[j] v_h[j]                  (p rounded to the compute dtype)
//   out[i] = LayerNorm(ctx[i] . W_o + b_o + hidden[i])    (eps, float32 stats)
//
// All Tp query rows are computed and written, as the TPU kernel does; rows at
// or past seq_len hold what the padding rows of q and hidden give.
//
// What bounds it on an H100: at B = 128, Tp = 160, E = 768 the products are
// 34 GFLOP against 161 MB of operands, under the tensor cores' ridge, so the
// least time is set by the bytes; this kernel's CUDA-core FMAs are far above
// either.  On the TPU, G amortised a per-program overhead.  Here the question
// becomes whether a block that walks G batch elements, keeping what the batch
// shares in shared memory, beats K1's one block per (element, head, query
// tile), which fetches both again from L2 for every element.
//
// Design: three launches, as K1, with the batch tile inside the block.
//  (a) tiled_attn_core: grid (query tile of 32 rows, head, B / G).  The head's
//      bias rows of the tile (32 x seq_len float32, 19 KB at seq_len 149) are
//      read once into shared memory and stay for the G elements; K_h and V_h
//      of one element at a time follow them (two of them do not fit G = 8
//      times beside the rest).  Each warp runs a query row through K1's
//      `attn_row`, with no dropout.
//  (b) tiled_out_proj: grid (column tile of 64, B / G).  The block's column
//      tile of W_o (E x 64, float32 in shared memory: 192 KB at E = 768) is
//      read once and stays while the block walks the G * Tp rows of its
//      elements in tiles of 64 through K1's tile product; + b_o + hidden,
//      written in float32 to a [B, Tp, E] scratch.
//  (c) K1's LayerNorm pass over all B * Tp rows.
// G changes which block computes a row and never how the row is reduced:
// every sum runs over the same index order with one accumulator, no atomics.
//
// These CUDA-core kernels keep the shapes outside the tensor-core route.
// Where the head width is 64 and seq_len <= 160 (K1's tensor-core route),
// `emo_wavlm_attn_tiled_tc_*` run K1's tensor-core arithmetic with the batch
// tile inside the block instead: `wavlm_attn_tiled_tc.cuh` (bfloat16) and
// `wavlm_attn_tiled_tf32.cuh` (float32, 3xTF32), then the same LayerNorm.

#include "wavlm_attn_tiled_tc.cuh"
#include "wavlm_attn_tiled_tf32.cuh"
#include "wavlm_sublayer.cuh"

namespace {

using emo::kAttnRows;
using emo::kAttnWarps;
using emo::kBK;
using emo::kBM;
using emo::kBN;
using emo::kGemmThreads;
using emo::kLnMaxPerLane;
using emo::kLnWarps;
using emo::kMaxSmem;
using emo::to_f;

template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
tiled_attn_core(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ gate,
                const float* __restrict__ bias, T* __restrict__ ctx, int G, int Tp,
                int seq_len, int E, int H) {
  extern __shared__ float smem[];
  const int dh = E / H;
  const int ks_stride = dh + 1;
  float* Ks = smem;                      // [seq_len][dh + 1]
  float* Vs = Ks + seq_len * ks_stride;  // [seq_len][dh]
  float* Qs = Vs + seq_len * dh;         // [warps][dh]
  float* Ps = Qs + kAttnWarps * dh;      // [warps][seq_len]
  float* Bs = Ps + kAttnWarps * seq_len; // [kAttnRows][seq_len]

  const int h = blockIdx.y, i0 = blockIdx.x * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // What the batch shares: the head's bias rows of this query tile.
  for (int idx = threadIdx.x; idx < kAttnRows * seq_len; idx += blockDim.x) {
    const int r = idx / seq_len, j = idx - r * seq_len;
    const int i = i0 + r;
    Bs[idx] = i < Tp ? bias[((size_t)h * Tp + i) * Tp + j] : 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int b = blockIdx.z * G + g;
    const size_t base = (size_t)b * Tp * E + (size_t)h * dh;
    __syncthreads();  // the previous element's K_h and V_h are done with
    for (int idx = threadIdx.x; idx < seq_len * dh; idx += blockDim.x) {
      const int j = idx / dh, d = idx - j * dh;
      const size_t at = base + (size_t)j * E + d;
      Ks[j * ks_stride + d] = to_f(k[at]);
      Vs[j * dh + d] = to_f(v[at]);
    }
    __syncthreads();

    for (int r = warp; r < kAttnRows; r += kAttnWarps) {
      const int i = i0 + r;
      if (i >= Tp) break;
      const size_t row = base + (size_t)i * E;
      emo::attn_row<T>(q + row, ctx + row, Ks, Vs, Qs + warp * dh, Ps + warp * seq_len,
                       Bs + r * seq_len, gate[((size_t)b * H + h) * Tp + i], seq_len, dh,
                       ks_stride, lane, 0u, 0u, 0u, 1.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
tiled_out_proj(const T* __restrict__ ctx, const T* __restrict__ hidden,
               const T* __restrict__ wo, const float* __restrict__ bo,
               float* __restrict__ proj, int rows_per_block, int E) {
  extern __shared__ float smem[];
  float* Ws = smem;                         // [E][kBN]
  float (*As)[kBM + 4] = reinterpret_cast<float (*)[kBM + 4]>(Ws + (size_t)E * kBN);  // [kBK][kBM + 4]
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // What the batch shares: this block's column tile of W_o.
  for (int idx = tid; idx < E * kBN; idx += kGemmThreads) {
    const int r = idx / kBN, c = idx - r * kBN;
    Ws[idx] = (n0 + c < E) ? to_f(wo[(size_t)r * E + n0 + c]) : 0.f;
  }

  const int first = blockIdx.y * rows_per_block, last = first + rows_per_block;
  for (int m0 = first; m0 < last; m0 += kBM) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < E; k0 += kBK) {
      __syncthreads();  // W_o's tile is in; the previous slice of A is done with
      emo::out_proj_stage_ctx(As, ctx, m0, k0, E, tid,
                              [=](int row) { return row < last; });
      __syncthreads();
      emo::out_proj_slice(acc, As, Ws + (size_t)k0 * kBN, tx, ty);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= last) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n >= E) continue;
        proj[(size_t)row * E + n] = acc[i][j] + bo[n] + to_f(hidden[(size_t)row * E + n]);
      }
    }
  }
}

template <typename T>
int launch(const void* hidden, const void* q, const void* k, const void* v,
           const void* gate, const void* bias, const void* wo, const void* bo,
           const void* lns, const void* lnb, void* ctx, void* proj, void* out,
           int G, int B, int Tp, int seq_len, int E, int H, float eps,
           void* stream_ptr) {
  if (G < 1 || B < 1 || B % G != 0 || H < 1 || E % H != 0 || seq_len < 1 ||
      seq_len > Tp || E > 32 * kLnMaxPerLane || E % kBK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int dh = E / H;

  const size_t smem_a = sizeof(float) * ((size_t)seq_len * (2 * dh + 1) +
                                         kAttnWarps * (dh + seq_len) +
                                         (size_t)kAttnRows * seq_len);
  const size_t smem_b = sizeof(float) * ((size_t)E * kBN + kBK * (kBM + 4));
  if (smem_a > kMaxSmem || smem_b > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_attn_core<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      tiled_out_proj<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;

  dim3 grid_a((Tp + kAttnRows - 1) / kAttnRows, H, B / G);
  tiled_attn_core<T><<<grid_a, kAttnWarps * 32, smem_a, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(gate), static_cast<const float*>(bias),
      static_cast<T*>(ctx), G, Tp, seq_len, E, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_b((E + kBN - 1) / kBN, B / G);
  tiled_out_proj<T><<<grid_b, kGemmThreads, smem_b, stream>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(hidden),
      static_cast<const T*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(proj), G * Tp, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int M = B * Tp;
  emo::wavlm_attn_ln<T><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      static_cast<const float*>(proj), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<T*>(out), M, Tp, Tp, E, eps);
  return cudaGetLastError();
}

// The tensor-core route: core and out-projection by `TC`'s launcher, then
// K1's LayerNorm over all B * Tp rows.
template <typename T, typename Launch>
int launch_tc(Launch core_and_proj, const void* hidden, const void* q, const void* k,
              const void* v, const void* gate, const void* bias, const void* wo, const void* bo,
              const void* lns, const void* lnb, void* ctx, void* proj, void* out, int G, int B,
              int Tp, int seq_len, int E, int H, float eps, void* stream_ptr) {
  if (G < 1 || B < 1 || B % G != 0 || H < 1 || seq_len < 1 || seq_len > Tp ||
      E > 32 * kLnMaxPerLane || B / G > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = core_and_proj(
      static_cast<const T*>(hidden), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(gate), static_cast<const float*>(bias),
      static_cast<const T*>(wo), static_cast<const float*>(bo), static_cast<T*>(ctx),
      static_cast<float*>(proj), G, B, Tp, seq_len, E, H, stream);
  if (err != cudaSuccess) return err;
  const int M = B * Tp;
  emo::wavlm_attn_ln<T><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      static_cast<const float*>(proj), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<T*>(out), M, Tp, Tp, E, eps);
  return cudaGetLastError();
}

}  // namespace

#define EMO_WAVLM_ATTN_TILED_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* hidden, const void* q, const void* k,         \
                      const void* v, const void* gate, const void* bias,        \
                      const void* wo, const void* bo, const void* lns,          \
                      const void* lnb, void* ctx, void* proj, void* out, int G, \
                      int B, int Tp, int seq_len, int E, int H, float eps,      \
                      void* stream) {                                           \
    return launch<T>(hidden, q, k, v, gate, bias, wo, bo, lns, lnb, ctx, proj,  \
                     out, G, B, Tp, seq_len, E, H, eps, stream);                \
  }

EMO_WAVLM_ATTN_TILED_ENTRY(emo_wavlm_attn_tiled_f32, float)
EMO_WAVLM_ATTN_TILED_ENTRY(emo_wavlm_attn_tiled_bf16, __nv_bfloat16)

// As the entries above, with `wo_t` (W_o transposed, float32 only: null for
// bfloat16) after `out`; the tensor-core route.
extern "C" int emo_wavlm_attn_tiled_tc_f32(const void* hidden, const void* q, const void* k,
                                           const void* v, const void* gate, const void* bias,
                                           const void* wo, const void* bo, const void* lns,
                                           const void* lnb, void* ctx, void* proj, void* out,
                                           const void* wo_t, int G, int B, int Tp, int seq_len,
                                           int E, int H, float eps, void* stream) {
  (void)wo;
  return launch_tc<float>(emo::tiled_tf32::launch_core_and_proj, hidden, q, k, v, gate, bias,
                          wo_t, bo, lns, lnb, ctx, proj, out, G, B, Tp, seq_len, E, H, eps,
                          stream);
}

extern "C" int emo_wavlm_attn_tiled_tc_bf16(const void* hidden, const void* q, const void* k,
                                            const void* v, const void* gate, const void* bias,
                                            const void* wo, const void* bo, const void* lns,
                                            const void* lnb, void* ctx, void* proj, void* out,
                                            const void* wo_t, int G, int B, int Tp, int seq_len,
                                            int E, int H, float eps, void* stream) {
  (void)wo_t;
  return launch_tc<__nv_bfloat16>(emo::tiled_tc::launch_core_and_proj, hidden, q, k, v, gate,
                                  bias, wo, bo, lns, lnb, ctx, proj, out, G, B, Tp, seq_len, E,
                                  H, eps, stream);
}
