// K1: the WavLM attention sublayer after the q/k/v projections, forward.
//
// Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
// pallas_wavlm_attn.py::_sublayer_kernel` (launched by `_forward_call`).
// Per batch element b, head h and query row i (q pre-scaled by dh^-0.5):
//
//   s[j]   = q_h[i] . k_h[j] + gate[b, h*Tp + i] * bias[h*Tp + i, j]   j < seq_len
//   p      = softmax(s)                        (float32; keys >= seq_len excluded)
//   ctx_h  = sum_j p[j] v_h[j]                 (p rounded to the compute dtype)
//   out[i] = LayerNorm(ctx[i] . W_o + b_o + hidden[i])   (eps, float32 stats)
//
// What bounds it on an H100: at the serving shapes (B <= 8, Tp = 149,
// E = 768, 12 heads) the score work is tiny (2*B*12*149*149*64*2 ~ 0.27 GFLOP
// at B = 8) and the out-projection is a 1192 x 768 x 768 GEMM (1.4 GFLOP);
// both sit below the tensor cores' ridge, so the sublayer is bound by
// latency and by the bytes it moves.  The modular path writes the float32
// score tensor [B, 12, 149, 149] (8.5 MB at B = 8) and the probabilities to
// device memory and reads them back, in four launches plus the head
// transposes.
//
// Design: three launches and no score tensor in device memory.
//  (a) wavlm_attn_core: one block per (query tile of 32 rows, head, batch).
//      K_h and V_h (seq_len x 64, float32) sit in shared memory; each warp
//      owns one query row at a time, computes its scores into a per-warp
//      shared row, does the float32 softmax with warp shuffles, and writes
//      ctx_h in the compute dtype to a [B, Tp, E] scratch.  K rows are padded
//      to 65 floats so lanes reading 32 different keys hit 32 banks.
//  (b) wavlm_attn_out_proj: ctx . W_o + b_o + hidden as a 64 x 64-tiled
//      product (each thread 4 x 4 outputs from shared memory), written in
//      float32 to a [B, Tp, E] scratch.  A first version did the product
//      and the LayerNorm in one block per 8 whole rows; every block then
//      re-read all of W_o and it took ~0.4 ms of K1's 0.53 ms at B = 8.
//  (c) wavlm_attn_ln: one warp per row, the LayerNorm from registers, one
//      write in the compute dtype.
// All use CUDA-core FMAs in float32: simple and right first; tensor cores
// (wgmma) and fewer launches are later work.
//
// Rows >= seq_len are neither computed nor written.  The dropout of the TPU
// kernel (training only) is not here: the wrapper refuses a rate above 0.

#include "common.cuh"

namespace {

using emo::from_f;
using emo::round_to;
using emo::to_f;

constexpr int kAttnWarps = 8;
constexpr int kAttnRows = 32;  // query rows per block (4 per warp)
constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;  // (b)
constexpr int kLnWarps = 8;     // rows per block of (c)
constexpr int kLnMaxPerLane = 32;  // E <= 1024
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ bool row_valid(int row, int M, int Tp, int seq_len) {
  return row < M && (row % Tp) < seq_len;
}

template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
wavlm_attn_core(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ gate,
                const float* __restrict__ bias, T* __restrict__ ctx, int Tp,
                int seq_len, int E, int H) {
  extern __shared__ float smem[];
  const int dh = E / H;
  const int ks_stride = dh + 1;
  float* Ks = smem;                      // [seq_len][dh + 1]
  float* Vs = Ks + seq_len * ks_stride;  // [seq_len][dh]
  float* Qs = Vs + seq_len * dh;         // [warps][dh]
  float* Ps = Qs + kAttnWarps * dh;      // [warps][seq_len]

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * Tp * E + (size_t)h * dh;

  for (int idx = threadIdx.x; idx < seq_len * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    const size_t g = base + (size_t)j * E + d;
    Ks[j * ks_stride + d] = to_f(k[g]);
    Vs[j * dh + d] = to_f(v[g]);
  }
  __syncthreads();

  float* qs = Qs + warp * dh;
  float* ps = Ps + warp * seq_len;
  for (int r = warp; r < kAttnRows; r += kAttnWarps) {
    const int i = blockIdx.x * kAttnRows + r;
    if (i >= seq_len) break;
    const size_t row = base + (size_t)i * E;
    for (int d = lane; d < dh; d += 32) qs[d] = to_f(q[row + d]);
    __syncwarp();

    const float g = gate[((size_t)b * H + h) * Tp + i];
    const float* brow = bias + ((size_t)h * Tp + i) * Tp;
    float m = -3.402823466e38f;  // -FLT_MAX
    for (int j = lane; j < seq_len; j += 32) {
      const float* kr = Ks + j * ks_stride;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qs[d], kr[d], s);
      s += g * brow[j];
      ps[j] = s;
      m = fmaxf(m, s);
    }
    m = emo::warp_max(m);
    float l = 0.f;
    for (int j = lane; j < seq_len; j += 32) {
      const float p = expf(ps[j] - m);
      ps[j] = p;
      l += p;
    }
    l = emo::warp_sum(l);
    const float inv = 1.f / l;
    __syncwarp();

    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq_len; ++j)
        acc = fmaf(round_to<T>(ps[j] * inv), Vs[j * dh + d], acc);
      ctx[row + d] = from_f<T>(acc);
    }
    __syncwarp();  // qs / ps are rewritten for the warp's next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
wavlm_attn_out_proj(const T* __restrict__ ctx, const T* __restrict__ hidden,
                    const T* __restrict__ wo, const float* __restrict__ bo,
                    float* __restrict__ proj, int M, int Tp, int seq_len, int E) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < E; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kGemmThreads; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int row = m0 + r, kk = k0 + c;
      As[c][r] = (kk < E && row_valid(row, M, Tp, seq_len))
                     ? to_f(ctx[(size_t)row * E + kk]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kGemmThreads; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int kk = k0 + r, n = n0 + c;
      Bs[r][c] = (kk < E && n < E) ? to_f(wo[(size_t)kk * E + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (!row_valid(row, M, Tp, seq_len)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < E)
        proj[(size_t)row * E + n] = acc[i][j] + bo[n] + to_f(hidden[(size_t)row * E + n]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
wavlm_attn_ln(const float* __restrict__ proj, const float* __restrict__ lns,
              const float* __restrict__ lnb, T* __restrict__ out, int M, int Tp,
              int seq_len, int E, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (!row_valid(row, M, Tp, seq_len)) return;
  const float* x = proj + (size_t)row * E;
  float v[kLnMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < E ? x[c] : 0.f;
    s += v[i];
  }
  const float mean = emo::warp_sum(s) / E;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < E) q += (v[i] - mean) * (v[i] - mean);
  }
  const float rstd = rsqrtf(emo::warp_sum(q) / E + eps);
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < E) out[(size_t)row * E + c] = from_f<T>((v[i] - mean) * rstd * lns[c] + lnb[c]);
  }
}

template <typename T>
int launch(const void* hidden, const void* q, const void* k, const void* v,
           const void* gate, const void* bias, const void* wo, const void* bo,
           const void* lns, const void* lnb, void* ctx, void* proj, void* out,
           int B, int Tp, int seq_len, int E, int H, float eps, void* stream_ptr) {
  if (B < 1 || H < 1 || E % H != 0 || seq_len < 1 || seq_len > Tp ||
      E > 32 * kLnMaxPerLane)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int dh = E / H;

  const size_t smem_a = sizeof(float) * ((size_t)seq_len * (2 * dh + 1) +
                                         kAttnWarps * (dh + seq_len));
  if (smem_a > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wavlm_attn_core<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  dim3 grid_a((seq_len + kAttnRows - 1) / kAttnRows, H, B);
  wavlm_attn_core<T><<<grid_a, kAttnWarps * 32, smem_a, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(gate), static_cast<const float*>(bias),
      static_cast<T*>(ctx), Tp, seq_len, E, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int M = B * Tp;
  dim3 grid_b((E + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  wavlm_attn_out_proj<T><<<grid_b, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(hidden),
      static_cast<const T*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(proj), M, Tp, seq_len, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  wavlm_attn_ln<T><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      static_cast<const float*>(proj), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<T*>(out), M, Tp, seq_len, E, eps);
  return cudaGetLastError();
}

}  // namespace

#define EMO_WAVLM_ATTN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* hidden, const void* q, const void* k,        \
                      const void* v, const void* gate, const void* bias,       \
                      const void* wo, const void* bo, const void* lns,         \
                      const void* lnb, void* ctx, void* proj, void* out,       \
                      int B, int Tp, int seq_len, int E, int H, float eps,     \
                      void* stream) {                                          \
    return launch<T>(hidden, q, k, v, gate, bias, wo, bo, lns, lnb, ctx, proj, \
                     out, B, Tp, seq_len, E, H, eps, stream);                  \
  }

EMO_WAVLM_ATTN_ENTRY(emo_wavlm_attn_f32, float)
EMO_WAVLM_ATTN_ENTRY(emo_wavlm_attn_bf16, __nv_bfloat16)
