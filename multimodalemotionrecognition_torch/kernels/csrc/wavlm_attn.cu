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
// Design: three launches and no score tensor in device memory.  At dh = 64
// and seq_len <= 160 launches (a) and (b) run on the tensor cores, with an
// exact softmax over the whole score row held in registers and a 64 x
// 64-tiled out-projection: in bfloat16 `wavlm_attn_tc.cuh` (mma.sync of bf16
// into float32), in float32 `wavlm_attn_tf32.cuh` (TF32 with split
// products, 3xTF32, at float32 accuracy: the scores and the out-projection
// on wgmma, P.V on mma.sync).  Beyond those shapes all three run on CUDA
// cores:
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
//      write in the compute dtype (both dtypes).
// The CUDA-core query row of (a), the tile product of (b) and the LayerNorm
// of (c) live in `wavlm_sublayer.cuh`, shared with the batch-tiled kernel
// (`wavlm_attn_tiled.cu`), which stays on CUDA cores: K6 agrees with K1
// within rounding (another sum order on the tensor-core routes).
//
// Rows >= seq_len are neither computed nor written.
//
// Training: both dropouts of the TPU kernel run in the kernel, from the same
// stateless hash (`emo::hash_keep`), so the backward (`wavlm_attn_bwd.cu`)
// regenerates the masks instead of reading them.  The probabilities are
// dropped in (a), in float32, before they are rounded to the compute dtype;
// the projected output in (b)'s epilogue, after + b_o and before the
// residual.  A threshold of 0 means no dropout.  The attention mask's index
// stride is the padded Tp, as in the TPU kernel.  The backward also reads
// the two scratch buffers: ctx and the pre-LayerNorm rows.

#include <type_traits>

#include "wavlm_attn_tc.cuh"
#include "wavlm_attn_tf32.cuh"
#include "wavlm_sublayer.cuh"

namespace {

using emo::from_f;
using emo::kAttnRows;
using emo::kAttnWarps;
using emo::kBK;
using emo::kBM;
using emo::kBN;
using emo::kGemmThreads;
using emo::kLnMaxPerLane;
using emo::kLnWarps;
using emo::kMaxSmem;
using emo::row_valid;
using emo::to_f;

template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
wavlm_attn_core(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ gate,
                const float* __restrict__ bias, T* __restrict__ ctx, int Tp,
                int seq_len, int E, int H, unsigned seed, const int* __restrict__ seed_dev,
                unsigned attn_thr, float attn_inv) {
  seed = emo::k1_seed(seed, seed_dev);  // issued first: its latency hides under the loads
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

  const unsigned stream = emo::attn_stream(seed, b, h);
  for (int r = warp; r < kAttnRows; r += kAttnWarps) {
    const int i = blockIdx.x * kAttnRows + r;
    if (i >= seq_len) break;
    const size_t row = base + (size_t)i * E;
    emo::attn_row<T>(q + row, ctx + row, Ks, Vs, Qs + warp * dh, Ps + warp * seq_len,
                     bias + ((size_t)h * Tp + i) * Tp, gate[((size_t)b * H + h) * Tp + i],
                     seq_len, dh, ks_stride, lane, stream, (unsigned)(i * Tp), attn_thr,
                     attn_inv);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
wavlm_attn_out_proj(const T* __restrict__ ctx, const T* __restrict__ hidden,
                    const T* __restrict__ wo, const float* __restrict__ bo,
                    float* __restrict__ proj, int M, int Tp, int seq_len, int E,
                    unsigned seed, const int* __restrict__ seed_dev, unsigned hid_thr,
                    float hid_inv) {
  seed = emo::k1_seed(seed, seed_dev);  // issued first: its latency hides under the loads
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
    emo::out_proj_stage_ctx(As, ctx, m0, k0, E, tid,
                            [=](int row) { return row_valid(row, M, Tp, seq_len); });
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kGemmThreads; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int kk = k0 + r, n = n0 + c;
      Bs[r][c] = (kk < E && n < E) ? to_f(wo[(size_t)kk * E + n]) : 0.f;
    }
    __syncthreads();
    emo::out_proj_slice(acc, As, &Bs[0][0], tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (!row_valid(row, M, Tp, seq_len)) continue;
    const unsigned stream = emo::hidden_stream(seed, row / Tp);
    const unsigned index0 = (unsigned)(row % Tp) * (unsigned)E;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= E) continue;
      float val = acc[i][j] + bo[n];
      if (hid_thr) val = emo::hash_keep(stream, index0 + n, hid_thr) ? val * hid_inv : 0.f;
      proj[(size_t)row * E + n] = val + to_f(hidden[(size_t)row * E + n]);
    }
  }
}

template <typename T>
int launch(const void* hidden, const void* q, const void* k, const void* v,
           const void* gate, const void* bias, const void* wo, const void* bo,
           const void* lns, const void* lnb, void* ctx, void* proj, void* out,
           const void* wo_t, const void* seed_dev_ptr, int B, int Tp, int seq_len, int E, int H,
           float eps, int seed, unsigned attn_thr, float attn_inv, unsigned hid_thr,
           float hid_inv, void* stream_ptr) {
  if (B < 1 || H < 1 || E % H != 0 || seq_len < 1 || seq_len > Tp ||
      E > 32 * kLnMaxPerLane)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int* seed_dev = static_cast<const int*>(seed_dev_ptr);
  const int dh = E / H;

  const int M = B * Tp;
  // dh = 64 and seq_len <= 160: (a) and (b) on the tensor cores, bf16 or 3xTF32.
  bool tensor_cores = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    tensor_cores = dh == emo::tc::kHeadDim && seq_len <= emo::tc::kMaxKeys;
  else
    tensor_cores = dh == emo::tf32::kHeadDim && seq_len <= emo::tf32::kMaxKeys;
  if (tensor_cores && std::is_same<T, float>::value) {
    const cudaError_t err = emo::tf32::launch_core_and_proj(
        static_cast<const float*>(hidden), static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(gate), static_cast<const float*>(bias),
        static_cast<const float*>(wo_t), static_cast<const float*>(bo), static_cast<float*>(ctx),
        static_cast<float*>(proj), B, Tp, seq_len, E, H, (unsigned)seed, seed_dev, attn_thr,
        attn_inv, hid_thr, hid_inv, stream);
    if (err != cudaSuccess) return err;
  } else if (tensor_cores) {
    const cudaError_t err = emo::tc::launch_core_and_proj(
        static_cast<const __nv_bfloat16*>(hidden), static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        static_cast<const float*>(gate), static_cast<const float*>(bias),
        static_cast<const __nv_bfloat16*>(wo), static_cast<const float*>(bo),
        static_cast<__nv_bfloat16*>(ctx), static_cast<float*>(proj), B, Tp, seq_len, E, H,
        (unsigned)seed, seed_dev, attn_thr, attn_inv, hid_thr, hid_inv, stream);
    if (err != cudaSuccess) return err;
  } else {
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
        static_cast<T*>(ctx), Tp, seq_len, E, H, (unsigned)seed, seed_dev, attn_thr, attn_inv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    dim3 grid_b((E + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    wavlm_attn_out_proj<T><<<grid_b, kGemmThreads, 0, stream>>>(
        static_cast<const T*>(ctx), static_cast<const T*>(hidden),
        static_cast<const T*>(wo), static_cast<const float*>(bo),
        static_cast<float*>(proj), M, Tp, seq_len, E, (unsigned)seed, seed_dev, hid_thr,
        hid_inv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  emo::wavlm_attn_ln<T><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      static_cast<const float*>(proj), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<T*>(out), M, Tp, seq_len, E, eps);
  return cudaGetLastError();
}

}  // namespace

// wo_t: W_o transposed, [E_out, E_in], read by the float32 tensor-core
// route only (null elsewhere).  seed_dev: null, or one int32 in device
// memory that every launch reads as the dropout seed in place of `seed`.
#define EMO_WAVLM_ATTN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* hidden, const void* q, const void* k,        \
                      const void* v, const void* gate, const void* bias,       \
                      const void* wo, const void* bo, const void* lns,         \
                      const void* lnb, void* ctx, void* proj, void* out,       \
                      const void* wo_t, const void* seed_dev, int B, int Tp,   \
                      int seq_len, int E, int H, float eps, int seed,          \
                      unsigned attn_thr, float attn_inv, unsigned hid_thr,     \
                      float hid_inv, void* stream) {                           \
    return launch<T>(hidden, q, k, v, gate, bias, wo, bo, lns, lnb, ctx, proj, \
                     out, wo_t, seed_dev, B, Tp, seq_len, E, H, eps, seed,     \
                     attn_thr, attn_inv, hid_thr, hid_inv, stream);            \
  }

EMO_WAVLM_ATTN_ENTRY(emo_wavlm_attn_f32, float)
EMO_WAVLM_ATTN_ENTRY(emo_wavlm_attn_bf16, __nv_bfloat16)
